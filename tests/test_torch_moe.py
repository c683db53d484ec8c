"""The port's MoE family (``paddle_tpu_torch/ops/moe.py``,
``nn/layer/moe.py``, ``models/moe_lm.py``) against the JAX package's on
the CPU.

The same inputs, made with numpy from a seed, go through both; JAX's
model parameters are carried into the port's by ``load_numpy_state``.
Float32 unless named. Tolerances, as a share of the largest |reference|:
- ``topk_gating``: dispatch and stats equal; combine within 1e-6 and
  aux within 1e-6 relative (sums taken in another order);
- ``moe_dispatch_combine`` / ``moe_ragged_forward`` with each activation:
  out, aux and the grads of x, gate_w, w1 and w2 within 1e-5; stats
  equal; dense equals ragged at ``capacity_factor = E`` within 1e-5, and
  ragged drops nothing when every token routes to one expert;
- ``MoELayer`` with each gate: out and aux within 1e-5, stats equal;
- ``MoEForCausalLM(moe_tiny)``, dense and ragged dispatch, plain and
  chunked cross entropy: logits (or hidden states) within 1e-5, the loss
  with its aux term within 1e-5 relative, every parameter's grad within
  1e-4 of its largest |grad| (under chunked CE JAX's compiled step gives
  ``lm_head.weight`` a zero grad, ROADMAP queue 3; the port's is held
  against its own plain-CE model's instead); five ``TrainStep``s of
  ``AdamW(1e-3)``: losses within 1e-5 relative;
- bf16 (``moe_tiny(dtype="bfloat16")``): the top-k experts of every token
  in the MoE layer equal JAX's, then the logits within two bf16 ulps
  (2**-6) of the largest |logit| (bf16 rounds at other places in the two
  frameworks);
- ``num_params`` / ``num_activated_params`` equal JAX's on small models
  shaped like each of bench.py's four moe rows (E, top-k, 8 layers,
  ``first_k_dense_replace`` 1, dispatch mode).
Also: the configs equal JAX's; ``tensor_parallel`` and an
expert-parallel fleet mesh raise ``NotImplementedError`` (recompute is
held in ``tests/test_torch_moe_recompute.py``); entry
points raise without a card unless given ``device="cpu"``; the grouped
product (``torch._grouped_mm``) and its grads equal a matmul per expert.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.models import moe_lm as jmoe_lm  # noqa: E402
from paddle_tpu.ops import moe as jmoe  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.distributed import fleet as tfleet  # noqa: E402
from paddle_tpu_torch.distributed import ProcessMesh  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import moe_lm as tmoe_lm  # noqa: E402
from paddle_tpu_torch.ops import moe as tmoe  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402

JAX_ACTS = {"gelu": jax.nn.gelu, "relu": jax.nn.relu, "silu": jax.nn.silu}
PORT_ACTS = {"gelu": tmoe.gelu_tanh, "relu": torch.relu,
             "silu": torch.nn.functional.silu}
# bench.py's moe rows (bench.py:409-431): E, top-k and dispatch mode at
# its 8 layers, first_k_dense_replace 1, at small widths
ROWS = {"moe_dense": dict(num_experts=8, moe_dispatch_mode="dense"),
        "moe_ragged": dict(num_experts=8, moe_dispatch_mode="ragged"),
        "moe_ragged_e64": dict(num_experts=64, moe_dispatch_mode="ragged"),
        "moe_ragged_wide": dict(num_experts=8, moe_dispatch_mode="ragged",
                                hidden_size=64)}


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _ffn_inputs(seed=0, b=2, s=16, d=32, h=64, e=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, d).astype(np.float32),
            (rng.randn(d, e) * 0.5).astype(np.float32),
            (rng.randn(e, d, h) * 0.1).astype(np.float32),
            (rng.randn(e, h, d) * 0.1).astype(np.float32))


# -- topk_gating ---------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_topk_gating_matches_jax(top_k):
    logits = np.random.RandomState(top_k).randn(48, 6).astype(np.float32)
    want = jmoe.topk_gating(jnp.asarray(logits), top_k, 16)
    got = tmoe.topk_gating(_t(logits), top_k, 16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].detach().numpy(), want[1], 1e-6, "combine")
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    for key in ("tokens_per_expert", "assigned_per_expert",
                "dropped_fraction"):
        np.testing.assert_array_equal(got[3][key].numpy(),
                                      np.asarray(want[3][key]), key)
    # 16 slots an expert for 48 * k assignments over 6: drops from k 2
    assert (float(got[3]["dropped_fraction"]) > 0) == (top_k > 1)


def test_topk_gating_tie_and_capacity_drop_match_jax():
    """All-zero logits tie: the first expert wins, 4 slots take 4 tokens
    (tests/test_parallel_advanced.py:209)."""
    logits = np.zeros((16, 2), np.float32)
    want = jmoe.topk_gating(jnp.asarray(logits), 1, 4)
    got = tmoe.topk_gating(_t(logits), 1, 4)
    assert float(got[0].sum()) == float(want[0].sum()) == 4.0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[3]["tokens_per_expert"].numpy(),
                                  [4.0, 0.0])
    assert float(got[3]["dropped_fraction"]) == \
        float(want[3]["dropped_fraction"]) == 0.75


# -- the two FFNs --------------------------------------------------------------

def _jax_ffn(mode, act, top_k, cf, x, gw, w1, w2, cot):
    def f(*args):
        if mode == "dense":
            return jmoe.moe_dispatch_combine(*args, top_k, cf, act)
        return jmoe.moe_ragged_forward(*args, top_k, act)

    def loss(*args):
        out, aux, _ = f(*args)
        return jnp.sum(out * cot) + aux

    out, aux, stats = jax.jit(f)(x, gw, w1, w2)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(x, gw, w1, w2)
    return out, aux, stats, grads


def _port_ffn(mode, act, top_k, cf, x, gw, w1, w2, cot):
    leaves = [_t(a).requires_grad_() for a in (x, gw, w1, w2)]
    if mode == "dense":
        out, aux, stats = tmoe.moe_dispatch_combine(*leaves, top_k, cf, act)
    else:
        out, aux, stats = tmoe.moe_ragged_forward(*leaves, top_k, act)
    ((out * _t(cot)).sum() + aux).backward()
    return out.detach(), aux.detach(), stats, [t.grad for t in leaves]


@pytest.mark.parametrize("act", sorted(JAX_ACTS))
@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_ffn_out_aux_stats_grads_match_jax(mode, act):
    x, gw, w1, w2 = _ffn_inputs()
    cot = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    # cf 1: the dense path drops tokens, so capacity is exercised
    want = _jax_ffn(mode, JAX_ACTS[act], 2, 1.0, x, gw, w1, w2, cot)
    got = _port_ffn(mode, PORT_ACTS[act], 2, 1.0, x, gw, w1, w2, cot)
    _close(got[0].numpy(), want[0], 1e-5, "out")
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    for key, v in want[2].items():
        np.testing.assert_array_equal(got[2][key].numpy(), np.asarray(v),
                                      key)
    if mode == "dense":
        assert float(got[2]["dropped_fraction"]) > 0
        assert float(got[2]["capacity"]) == 8.0
    for name, g, w in zip(("x", "gate_w", "w1", "w2"), got[3], want[3]):
        _close(g.numpy(), w, 1e-5, name)
        assert np.abs(np.asarray(w)).max() > 0, name


def test_dense_equals_ragged_without_drops():
    """capacity_factor E: every token fits (test_parallel_advanced.py:476)."""
    x, gw, w1, w2 = (_t(a) for a in _ffn_inputs(seed=3))
    dense = tmoe.moe_dispatch_combine(x, gw, w1, w2, 2, 8.0)
    ragged = tmoe.moe_ragged_forward(x, gw, w1, w2, 2)
    assert float(dense[2]["dropped_fraction"]) == 0.0
    _close(ragged[0].numpy(), dense[0].numpy(), 1e-5)
    np.testing.assert_allclose(float(ragged[1]), float(dense[1]), rtol=1e-6)
    np.testing.assert_array_equal(ragged[2]["tokens_per_expert"].numpy(),
                                  dense[2]["tokens_per_expert"].numpy())
    assert tmoe.moe_mlp_forward is tmoe.moe_dispatch_combine


def test_ragged_is_dropless_under_skew():
    """Every token routes to expert 3: dense at cf 1 drops most of them,
    ragged none, as in JAX (test_parallel_advanced.py:498)."""
    rng = np.random.RandomState(1)
    x = (np.abs(rng.randn(1, 32, 16)) + 0.1).astype(np.float32)
    gw = np.zeros((16, 8), np.float32)
    gw[:, 3] = 5.0
    w1 = (rng.randn(8, 16, 32) * 0.1).astype(np.float32)
    w2 = (rng.randn(8, 32, 16) * 0.1).astype(np.float32)
    dense = tmoe.moe_dispatch_combine(_t(x), _t(gw), _t(w1), _t(w2), 1, 1.0)
    ragged = tmoe.moe_ragged_forward(_t(x), _t(gw), _t(w1), _t(w2), 1)
    j_ragged = jmoe.moe_ragged_forward(x, gw, w1, w2, 1)
    assert float(dense[2]["dropped_fraction"]) >= 0.5
    assert float(ragged[2]["dropped_fraction"]) == 0.0
    assert float(ragged[2]["tokens_per_expert"][3]) == 32
    _close(ragged[0].numpy(), j_ragged[0], 1e-5)


def test_grouped_product_routes_on_the_cpu():
    """The grouped product (torch._grouped_mm over the int32 end offsets,
    on every device and dtype) equals one matmul per expert over its
    contiguous rows, empty groups included, in float32 and bf16: the
    product, and the grads of lhs and rhs through autograd."""
    rng = np.random.RandomState(5)
    sizes = torch.tensor([3, 0, 5, 2])
    lhs_np = rng.randn(10, 16).astype(np.float32)
    rhs_np = rng.randn(4, 16, 8).astype(np.float32)
    g = _t(rng.randn(10, 8).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        got, want = [], []
        for fn, res in (("grouped", got), ("loop", want)):
            lhs = _t(lhs_np).to(dt).requires_grad_()
            rhs = _t(rhs_np).to(dt).requires_grad_()
            if fn == "grouped":
                y = tmoe._grouped_mm(lhs, rhs, sizes)
            else:
                y = torch.cat([part @ rhs[i] for i, part in
                               enumerate(torch.split(lhs, sizes.tolist()))])
            y.backward(g.to(dt))
            res += [t_.float().detach().numpy()
                    for t_ in (y, lhs.grad, rhs.grad)]
        for a_, b_ in zip(got, want):
            np.testing.assert_array_equal(a_, b_)
        assert not got[2][1].any()         # the empty group's weight grad


# -- MoELayer ------------------------------------------------------------------

GATES = {"gshard": lambda m: "gshard", "switch": lambda m: "switch",
         "gshard_top3": lambda m: m.GShardGate(top_k=3),
         "switch_gate": lambda m: m.SwitchGate()}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_moe_layer_matches_jax(gate):
    kw = dict(d_model=16, d_hidden=32, num_experts=4,
              capacity_factor=2.0)
    paddle.seed(0)
    jl = jnn.MoELayer(gate=GATES[gate](jnn), **kw)
    tl = tnn.MoELayer(gate=GATES[gate](tnn), device="cpu", **kw)
    tl.load_state_dict({n: _t(p._value) for n, p in jl.named_parameters()})
    assert tl.top_k == jl.top_k == {"gshard": 2, "switch": 1,
                                    "gshard_top3": 3, "switch_gate": 1}[gate]
    x = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
    want = jl(paddle.to_tensor(x))
    got = tl(_t(x))
    _close(got.detach().numpy(), np.asarray(want._value), 1e-5)
    np.testing.assert_allclose(float(tl.aux_loss.detach()),
                               float(np.asarray(jl.aux_loss._value)),
                               rtol=1e-5)
    for key, v in jl.routing_stats.items():
        np.testing.assert_array_equal(tl.routing_stats[key].numpy(),
                                      np.asarray(v._value), key)


def test_moe_layer_refusals():
    with pytest.raises(ValueError, match="dispatch_mode"):
        tnn.MoELayer(8, 16, 2, dispatch_mode="sparse", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnn.MoELayer(8, 16, 2)
    for axis in ("ep", "mp"):
        mesh = ProcessMesh([0, 1], [axis], devices=["cpu"] * 2)
        tfleet._hcg = type("HCG", (), {"mesh": mesh})()
        try:
            with pytest.raises(NotImplementedError, match="item 2"):
                tnn.MoELayer(8, 16, 2, device="cpu")
        finally:
            tfleet._hcg = None


# -- MoEForCausalLM ------------------------------------------------------------

def _cfgs(**kw):
    return jmoe_lm.moe_tiny(**kw), tmoe_lm.moe_tiny(**kw)


@functools.lru_cache(maxsize=None)
def _jax_model(**kw):
    """One JAX model per config (its eager init takes seconds)."""
    paddle.seed(0)
    return jmoe_lm.MoEForCausalLM(_cfgs(**kw)[0])


def _pair(**kw):
    jm = _jax_model(**kw)
    tm = tmoe_lm.MoEForCausalLM(_cfgs(**kw)[1], device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _ids(b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 512, (b, s)) \
        .astype(np.int32)


def _jax_step(jm):
    return paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))


def _port_grads(tm, ids):
    for p in tm.parameters():
        p.grad = None
    out = tm(_t(ids))
    loss = tm.loss(out, _t(ids))
    loss.backward()
    return out.detach(), float(loss.detach()), {n: p.grad for n, p in
                                       tm.named_parameters()}


@pytest.mark.parametrize("chunked", [0, 8])
@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_model_forward_loss_grads_match_jax(mode, chunked):
    kw = dict(moe_dispatch_mode=mode, chunked_ce_tokens=chunked)
    jm, tm = _pair(**kw)
    ids = _ids()
    jstep = _jax_step(jm)
    params = [p._value for p in jstep._p_tensors]
    j_out, _ = jax.jit(lambda ps, x: paddle.jit.functional_call(
        jm, ps, [], (x,)))(params, ids)
    j_loss, _, j_grads = jax.jit(jstep._make_loss_and_grads())(
        params, [], jax.random.PRNGKey(0), (ids,), (ids,))
    j_grads = dict(zip(jstep._param_names, j_grads))
    out, loss, grads = _port_grads(tm, ids)
    _close(out.numpy(), j_out, 1e-5, "logits / hidden")
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    aux = tm.model.aux_losses()
    assert len(aux) == 1 and float(aux[0]) > 0
    assert list(grads) == list(j_grads)
    for name, g in j_grads.items():
        if chunked and name == "lm_head.weight":
            assert not np.asarray(g).any()        # JAX's known zero grad
            plain = tmoe_lm.MoEForCausalLM(_cfgs(moe_dispatch_mode=mode)[1],
                                           device="cpu")
            plain.load_numpy_state({n: p.detach().numpy()
                                    for n, p in tm.named_parameters()})
            _, _, plain = _port_grads(plain, ids)
            _close(grads[name].numpy(), plain[name].numpy(), 1e-5, name)
            continue
        _close(grads[name].numpy(), g, 1e-4, name)
        assert np.abs(np.asarray(g)).max() > 0, name


def test_inert_tensor_parallel_matches_jax():
    """tensor_parallel=True with no fleet mesh builds the plain model,
    as JAX's _mp_active() gating does: JAX's logits and grads."""
    jm, tm = _pair(tensor_parallel=True)
    ids = _ids()
    jstep = _jax_step(jm)
    params = [p._value for p in jstep._p_tensors]
    j_out, _ = jax.jit(lambda ps, x: paddle.jit.functional_call(
        jm, ps, [], (x,)))(params, ids)
    j_loss, _, j_grads = jax.jit(jstep._make_loss_and_grads())(
        params, [], jax.random.PRNGKey(0), (ids,), (ids,))
    out, loss, grads = _port_grads(tm, ids)
    _close(out.numpy(), j_out, 1e-5, "logits")
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    for name, g in zip(jstep._param_names, j_grads):
        _close(grads[name].numpy(), g, 1e-4, name)


@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_train_steps_match_jax(mode):
    jm, tm = _pair(moe_dispatch_mode=mode)
    ids = _ids(seed=1)
    jstep = _jax_step(jm)
    tstep = TrainStep(tm, lambda o, l: tm.loss(o, l),
                      AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    jx = paddle.to_tensor(ids)
    j_losses = [float(jstep(jx, jx)) for _ in range(5)]
    t_losses = [float(tstep(_t(ids), _t(ids))) for _ in range(5)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]


def _recording(fn, top, record):
    """fn (an FFN) that also records its tokens' top-k expert sets."""
    def run(x, gw, w1, w2, top_k, *a, **k):
        top(x, gw, top_k, lambda idx: record.append(
            np.sort(np.asarray(idx), -1)))
        return fn(x, gw, w1, w2, top_k, *a, **k)
    return run


@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_bf16_forward_matches_jax(mode, monkeypatch):
    jm, tm = _pair(moe_dispatch_mode=mode, dtype="bfloat16")
    assert tm.model.layers[0].input_layernorm.weight.dtype == torch.bfloat16
    assert tm.model.layers[1].mlp.moe.w1.dtype == torch.float32
    ids = _ids(seed=2)
    j_route, t_route = [], []

    def j_top(x, gw, k, note):
        p = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                           @ gw.astype(jnp.float32), axis=-1)
        jax.debug.callback(note, jax.lax.top_k(p, k)[1])

    def t_top(x, gw, k, note):
        p = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ gw.float(),
                          dim=-1)
        note(torch.sort(p, dim=-1, descending=True, stable=True)
             .indices[:, :k].numpy())

    name = "moe_dispatch_combine" if mode == "dense" else \
        "moe_ragged_forward"
    monkeypatch.setattr(jmoe, name,
                        _recording(getattr(jmoe, name), j_top, j_route))
    monkeypatch.setattr(tmoe, name,
                        _recording(getattr(tmoe, name), t_top, t_route))
    want, _ = jax.jit(lambda ps, x: paddle.jit.functional_call(
        jm, ps, [], (x,)))([p._value for p in jm.parameters()], ids)
    want = np.asarray(want, np.float32)
    got = tm(_t(ids)).detach().float().numpy()
    assert len(j_route) == len(t_route) == 1
    np.testing.assert_array_equal(t_route[0], j_route[0])
    _close(got, want, 2.0 ** -6, "bf16 logits")


@functools.lru_cache(maxsize=None)
def _jax_row_model(num_experts, hidden_size=32, **_mode):
    """bench.py's moe rows at small widths; the parameters do not depend
    on the dispatch mode, so dense and ragged share one JAX model."""
    return jmoe_lm.MoEForCausalLM(jmoe_lm.MoEConfig(
        **_ROW_BASE, num_experts=num_experts, hidden_size=hidden_size))


_ROW_BASE = dict(vocab_size=128, intermediate_size=64,
                 moe_intermediate_size=16, num_hidden_layers=8,
                 num_attention_heads=2, num_key_value_heads=1,
                 num_experts_per_tok=2, first_k_dense_replace=1)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_param_counts_match_jax(row):
    jm = _jax_row_model(**{k: v for k, v in ROWS[row].items()
                           if k != "moe_dispatch_mode"})
    tm = tmoe_lm.MoEForCausalLM(tmoe_lm.MoEConfig(
        **_ROW_BASE, **dict(dict(hidden_size=32), **ROWS[row])),
        device="cpu")
    assert [(n, tuple(p.shape)) for n, p in jm.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in tm.named_parameters()]
    assert tm.num_params() == jm.num_params()
    assert tm.num_activated_params() == jm.num_activated_params()
    assert tm.num_activated_params() < tm.num_params()


def test_configs_match_jax():
    for name in ("moe_tiny", "deepseek_moe_16b_like",
                 "qwen2_moe_a14b_like"):
        assert dataclasses.asdict(getattr(jmoe_lm, name)()) == \
            dataclasses.asdict(getattr(tmoe_lm, name)()), name
    assert dataclasses.asdict(jmoe_lm.moe_tiny(num_experts=8)) == \
        dataclasses.asdict(tmoe_lm.moe_tiny(num_experts=8))


def test_model_refusals():
    # under an mp mesh JAX shards the experts over mp: expert parallelism
    strategy = tfleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    tfleet.init(strategy=strategy, devices=["cpu"] * 2)
    try:
        with pytest.raises(NotImplementedError, match="item 2"):
            tmoe_lm.MoEForCausalLM(tmoe_lm.moe_tiny(tensor_parallel=True),
                                   device="cpu")
    finally:
        tfleet._hcg = tfleet._strategy = None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmoe_lm.MoEForCausalLM(tmoe_lm.moe_tiny())
