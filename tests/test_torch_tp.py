"""Training's tensor and sequence parallelism
(``paddle_tpu_torch/distributed/fleet/mpu.py``,
``sequence_parallel_utils.py``, and ``tensor_parallel`` in the Llama and
GPT models) against the JAX package on the CPU.

JAX runs its layers and models on its 8-device CPU mesh
(``tests/conftest.py``), mp 2 or 4 with dp filled in; the port runs the
same mp on ``["cpu"] * mp``. The same numpy inputs go to both, and JAX's
weights are carried into the port by logical name
(``load_numpy_state``), so every check compares the two functions on
the same state:
- the hybrid group's queries, and each Megatron layer (column, row, the
  column -> row MLP pair, the vocab embedding, the cross entropy) as
  JAX's ``TestFleetTP`` drives it, with the input's and every
  parameter's gradient;
- the sequence-parallel pair as ``TestSequenceParallel`` drives it, with
  gradients, and the reduce-scatter's per-rank chunks;
- llama_tiny and gpt_tiny (float32, ``tensor_parallel=True``, mp 2):
  logits, loss and every logical gradient, then the losses of 3
  ``TrainStep``s with AdamW and a mixed ``apply_decay_param_fun``;
  recompute at its three granularities, tied embeddings, chunked cross
  entropy (its loss; its grads against the port's own plain-CE tp
  model, as JAX's compiled step drops the head's share) and
  ``generate()``'s greedy tokens;
- the logical parameter view: names and full shapes equal JAX's, each
  shard on its rank's device and no full copy held, a ``state_dict``
  round trip exact, and one seed giving the same weights at mp 1 and 2;
  a clipped step (ClipGradByNorm per logical parameter, the global norm
  over every shard) at mp 2 equal to mp 1's.

Tolerance: 1e-5 relative in float32, read as max |port - JAX| <= 1e-5 x
max |JAX| over each compared tensor.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
import paddle_tpu.distributed.fleet as jfleet  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JaxGPT  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JaxLlama  # noqa: E402
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_llama_tiny  # noqa: E402
from paddle_tpu_torch.distributed import fleet as tfleet  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,  # noqa: E402,E501
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.numpy_bridge import load_numpy_state  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jfleet._hcg = None
    tfleet._hcg = None
    tfleet._strategy = None


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} x {scale}"


def _meshes(mp, dp_degree=None):
    """JAX's fleet over its 8 devices and the port's over ["cpu"] * mp,
    both at mp."""
    hc = {"mp_degree": mp}
    if dp_degree is not None:
        hc["dp_degree"] = dp_degree
    s = jdist.fleet.DistributedStrategy()
    s.hybrid_configs = hc
    jfleet.init(is_collective=True, strategy=s)
    t = tfleet.DistributedStrategy()
    t.hybrid_configs = {"mp_degree": mp}
    return tfleet.init(strategy=t, devices=["cpu"] * mp)


def _state(jlayer):
    return {n: np.asarray(p._value) for n, p in jlayer.named_parameters()}


def _run_layer(jlayer, tlayer, x, ids=False):
    """Both layers on x with the loss sum(out * c): (out, input grad or
    None, {name: grad}) for each side."""
    load_numpy_state(tlayer, _state(jlayer))
    jx = paddle.to_tensor(x, stop_gradient=ids)
    jout = jlayer(jx)
    c = np.random.RandomState(1).randn(*jout.shape).astype(np.float32)
    (jout * paddle.to_tensor(c)).sum().backward()
    tx = torch.as_tensor(x)
    if not ids:
        tx.requires_grad_(True)
    tout = tlayer(tx)
    (tout * torch.as_tensor(c)).sum().backward()
    jg = {n: p.grad.numpy() for n, p in jlayer.named_parameters()}
    tg = {n: p.grad.numpy() for n, p in tlayer.named_parameters()}
    assert list(jg) == list(tg)
    return ((jout.numpy(), None if ids else jx.grad.numpy(), jg),
            (tout.detach().numpy(), None if ids else tx.grad.numpy(), tg))


def _check_layer(j, t, what):
    _close(t[0], j[0], f"{what} out")
    if j[1] is not None:
        _close(t[1], j[1], f"{what} input grad")
    for n in j[2]:
        _close(t[2][n], j[2][n], f"{what} {n} grad")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the hybrid group and the Megatron layers (TestFleetTP) ----------------

@pytest.mark.parametrize("mp", [2, 4])
def test_hcg_queries_equal_jax(mp):
    hcg = _meshes(mp)
    jh = jfleet.get_hybrid_communicate_group()
    assert hcg.get_model_parallel_world_size() == \
        jh.get_model_parallel_world_size() == mp
    assert hcg.get_parallel_mode() == jh.get_parallel_mode() == \
        "tensor_parallel"
    assert hcg.get_model_parallel_rank() == jh.get_model_parallel_rank()
    assert hcg.get_model_parallel_group() == jh.get_model_parallel_group()
    assert hcg.mesh.axis_devices("mp") == [torch.device("cpu")] * mp
    assert hcg.get_data_parallel_world_size() == 1


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(gather):
    _meshes(4)
    paddle.seed(0)
    j = jdist.fleet.ColumnParallelLinear(16, 32, gather_output=gather)
    t = tfleet.ColumnParallelLinear(16, 32, gather_output=gather,
                                    device="cpu")
    assert [s.shape for s in t.shards("weight")] == [(16, 8)] * 4
    assert [s.shape for s in t.shards("bias")] == [(8,)] * 4
    _check_layer(*_run_layer(j, t, _x(4, 16)), f"column gather={gather}")


@pytest.mark.parametrize("parallel", [False, True])
def test_row_parallel_linear(parallel):
    _meshes(4)
    paddle.seed(0)
    j = jdist.fleet.RowParallelLinear(32, 16, input_is_parallel=parallel)
    t = tfleet.RowParallelLinear(32, 16, input_is_parallel=parallel,
                                 device="cpu")
    assert [s.shape for s in t.shards("weight")] == [(8, 16)] * 4
    assert t.shards("bias")[0].shape == (16,)       # replicated
    _check_layer(*_run_layer(j, t, _x(4, 32)), f"row parallel={parallel}")


def test_mlp_pair_matches_jax_and_dense():
    """Column -> ReLU -> row, the pair JAX's test_mlp_tp_matches_single
    drives; also against the dense numpy product."""
    _meshes(4)
    paddle.seed(3)
    jc = jdist.fleet.ColumnParallelLinear(8, 32, gather_output=False)
    jr = jdist.fleet.RowParallelLinear(32, 8, input_is_parallel=True)
    tc = tfleet.ColumnParallelLinear(8, 32, gather_output=False,
                                     device="cpu")
    tr = tfleet.RowParallelLinear(32, 8, input_is_parallel=True,
                                  device="cpu")

    class JPair(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.col, self.row = jc, jr

        def forward(self, x):
            return self.row(paddle.nn.functional.relu(self.col(x)))

    class TPair(tfleet.mpu.LogicalParameters, torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.col, self.row = tc, tr

        def forward(self, x):
            acts = [torch.relu(y) for y in self.col.shard_forward(x)]
            return self.row.shard_forward(acts, like=x)

    j, t = _run_layer(JPair(), TPair(), _x(4, 8))
    _check_layer(j, t, "mlp pair")
    x = _x(4, 8)
    w = _state(JPair())
    h = np.maximum(x @ w["col.weight"] + w["col.bias"], 0)
    want = h @ w["row.weight"] + w["row.bias"]
    _close(TPair()(torch.as_tensor(x)).detach().numpy(), want, "dense")


def test_vocab_parallel_embedding_and_cross_entropy():
    _meshes(4)
    paddle.seed(0)
    j = jdist.fleet.VocabParallelEmbedding(64, 16)
    t = tfleet.VocabParallelEmbedding(64, 16, device="cpu")
    assert [s.shape for s in t.shards("weight")] == [(16, 16)] * 4
    ids = np.array([[1, 5, 63, 16], [15, 31, 32, 48]], np.int64)
    jo, to = _run_layer(j, t, ids, ids=True)
    _check_layer(jo, to, "vocab embedding")
    np.testing.assert_array_equal(to[0], _state(j)["weight"][ids])
    logits = _x(6, 64)
    labels = np.array([3, 63, -100, 17, 0, 40], np.int64)
    jl = jdist.fleet.ParallelCrossEntropy()(paddle.to_tensor(logits),
                                            paddle.to_tensor(labels))
    tl = tfleet.ParallelCrossEntropy()(torch.as_tensor(logits),
                                       torch.as_tensor(labels))
    _close(tl.numpy(), jl.numpy(), "parallel cross entropy")


def test_layers_without_mesh_are_plain():
    """No fleet mesh: one plain parameter a name, as JAX's layers."""
    t = tfleet.ColumnParallelLinear(8, 12, device="cpu")
    assert [n for n, _ in t.named_parameters()] == ["weight", "bias"]
    assert t.mp_degree == 1 and t.shards("weight")[0] is t.weight
    x = torch.as_tensor(_x(3, 8))
    torch.testing.assert_close(t(x), x @ t.weight + t.bias)


def test_shards_that_do_not_divide_raise():
    _meshes(4)
    with pytest.raises(ValueError, match="does not divide"):
        tfleet.ColumnParallelLinear(8, 10, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tfleet.VocabParallelEmbedding(30, 8, device="cpu")


# -- sequence parallelism (TestSequenceParallel) ---------------------------

def test_sequence_parallel_pair_matches_jax():
    _meshes(4, dp_degree=2)
    paddle.seed(0)
    jc = jdist.fleet.ColumnSequenceParallelLinear(8, 16,
                                                  gather_output=False)
    jr = jdist.fleet.RowSequenceParallelLinear(16, 8)
    tc = tfleet.ColumnSequenceParallelLinear(8, 16, gather_output=False,
                                             device="cpu")
    tr = tfleet.RowSequenceParallelLinear(16, 8, device="cpu")

    class JPair(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.col, self.row = jc, jr

        def forward(self, x):
            xs = jdist.fleet.ScatterOp(x)
            out = self.row(paddle.nn.functional.relu(self.col(xs)))
            return jdist.fleet.GatherOp(out)

    class TPair(tfleet.mpu.LogicalParameters, torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.col, self.row = tc, tr

        def forward(self, x):
            xs = tfleet.ScatterOp(x)
            out = self.row(torch.relu(self.col(xs)))
            return tfleet.GatherOp(out)

    x = _x(2, 8, 8)                       # [b, s, d]; s over mp 4
    j, t = _run_layer(JPair(), TPair(), x)
    _check_layer(j, t, "sequence-parallel pair")
    # the per-rank lists: the chunks of the reduce-scatter, rank j
    # holding sequence chunk j of the summed product
    from paddle_tpu_torch.distributed.fleet import sequence_parallel_utils \
        as sp
    devs = [torch.device("cpu")] * 4
    xs = sp.scatter_sequence(torch.as_tensor(x), devs)
    assert [c.shape[1] for c in xs] == [2] * 4
    acts = [torch.relu(y) for y in tc.shard_forward(xs)]
    chunks = tr.shard_forward(acts)
    _close(sp.gather_sequence(chunks).detach().numpy(), j[0], "chunks")
    _close(chunks[3].detach().numpy(), j[0][:, 6:8], "rank 3's chunk")


def test_scatter_checks_the_sequence_and_mark_refuses_tensors():
    _meshes(4)
    with pytest.raises(ValueError, match="does not divide"):
        tfleet.ScatterOp(torch.zeros(2, 6, 4))
    x = torch.zeros(2, 8, 4)
    assert tfleet.GatherOp(tfleet.ScatterOp(x)) is x
    mark = tfleet.sequence_parallel_utils.mark_as_sequence_parallel_parameter
    p = torch.nn.Parameter(torch.zeros(3))
    assert mark(p) is p and p.sequence_parallel
    with pytest.raises(TypeError, match="Parameter"):
        mark(torch.zeros(3))


# -- the models -------------------------------------------------------------

def _ids(vocab, b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(b, s)).astype(np.int32)


_FAMILIES = {
    "llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM, llama_tiny),
    "gpt": (JaxGPT, jax_gpt_tiny, GPTForCausalLM, gpt_tiny),
}


def _pair(family, mp=2, **kw):
    """JAX's tp model at mp (paddle.seed(0)) and the port's, carrying
    JAX's weights by logical name."""
    jcls, jcfg, tcls, tcfg = _FAMILIES[family]
    _meshes(mp)
    paddle.seed(0)
    jm = jcls(jcfg(tensor_parallel=True, **kw))
    tm = tcls(tcfg(tensor_parallel=True, **kw), device="cpu")
    tm.load_numpy_state(_state(jm))
    return jm, tm


def _jax_grads(jm, ids):
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    params = [p._value for p in jstep._p_tensors]
    logits, _ = jax.jit(
        lambda ps, x: paddle.jit.functional_call(jm, ps, [], (x,)))(
        params, ids)
    loss, _, grads = jax.jit(jstep._make_loss_and_grads())(
        params, [], jax.random.PRNGKey(0), (ids,), (ids,))
    return np.asarray(logits), float(loss), {
        n: np.asarray(g) for n, g in zip(jstep._param_names, grads)}


def _port_grads(tm, ids):
    tm.zero_grad()
    tx = torch.as_tensor(ids)
    out = tm(tx)
    loss = tm.loss(out, tx)
    loss.backward()
    return out.detach().numpy(), float(loss), {
        n: p.grad.numpy() for n, p in tm.named_parameters()}


def _check_model(jm, tm, ids, what, logits=True):
    jl, jloss, jg = _jax_grads(jm, ids)
    tl, tloss, tg = _port_grads(tm, ids)
    if logits:
        _close(tl, jl, f"{what} logits")
    _close(tloss, jloss, f"{what} loss")
    assert sorted(tg) == sorted(jg)
    for n in jg:
        _close(tg[n], jg[n], f"{what} grad {n}")


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_model_logits_loss_grads_and_steps(family):
    jm, tm = _pair(family)
    ids = _ids(tm.cfg.vocab_size)
    _check_model(jm, tm, ids, family)

    def decay(n):
        return "norm" not in n and "ln" not in n and "bias" not in n
    # JAX's AdamW reads each Parameter's own name: the same mask by it
    jnames = {p.name for n, p in jm.named_parameters() if decay(n)}
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    apply_decay_param_fun=lambda name: name in jnames)
    jstep = paddle.jit.TrainStep(jm, lambda o, l: jm.loss(o, l), jo)
    to = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
               apply_decay_param_fun=decay)
    assert len(to._parameter_list) > len(list(tm.parameters()))
    tstep = TrainStep(tm, lambda o, l: tm.loss(o, l), to)
    jx, tx = paddle.to_tensor(ids), torch.as_tensor(ids)
    jl = [float(jstep(jx, jx)) for _ in range(3)]
    tl = [float(tstep(tx, tx)) for _ in range(3)]
    _close(tl, jl, f"{family} TrainStep losses")


@pytest.mark.parametrize("gran", ["full", "full_attn", "core_attn"])
def test_llama_recompute(gran):
    jm, tm = _pair("llama", use_recompute=True, recompute_granularity=gran)
    _check_model(jm, tm, _ids(512, s=8), f"recompute {gran}", logits=False)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_tied_embeddings(family):
    kw = dict(tie_word_embeddings=True) if family == "llama" else {}
    jm, tm = _pair(family, **kw)
    assert tm.lm_head is None
    _check_model(jm, tm, _ids(512, s=8), f"{family} tied")


def test_gpt_untied_head_and_strided_qkv():
    """gpt_tiny untied; rank r's qkv shard is its own heads' q, k and v
    columns (a strided cut), while the logical weight keeps JAX's
    [hidden, 3 * hidden] layout."""
    jm, tm = _pair("gpt", tie_word_embeddings=False)
    _check_model(jm, tm, _ids(512, s=8), "gpt untied")
    qkv = tm.gpt.layers[0].attn.qkv_proj
    full = dict(tm.named_parameters())["gpt.layers.0.attn.qkv_proj.weight"]
    w0 = qkv.shards("weight")[0]
    h = tm.cfg.hidden_size
    want = torch.cat([full[:, i * h:i * h + h // 2] for i in range(3)], 1)
    torch.testing.assert_close(w0, want, rtol=0, atol=0)


def test_llama_chunked_ce():
    jm, tm = _pair("llama", chunked_ce_tokens=8)
    ids = _ids(512, s=16)
    _, jloss, _ = _jax_grads(jm, ids)
    _, tloss, tg = _port_grads(tm, ids)
    _close(tloss, jloss, "chunked CE loss")
    plain = LlamaForCausalLM(llama_tiny(tensor_parallel=True), device="cpu")
    plain.load_state_dict(tm.state_dict())
    _, ploss, pg = _port_grads(plain, ids)
    _close(tloss, ploss, "chunked vs plain CE loss")
    for n in pg:
        _close(tg[n], pg[n], f"chunked CE grad {n}")


def test_llama_generate_tokens():
    jm, tm = _pair("llama")
    prompt = _ids(512, b=2, s=6, seed=3)
    jt = np.asarray(jm.generate(paddle.to_tensor(prompt),
                                max_new_tokens=5)._value)
    tt = tm.generate(torch.as_tensor(prompt), max_new_tokens=5)
    np.testing.assert_array_equal(tt.numpy(), jt)


# -- the logical parameter view ---------------------------------------------

def test_logical_view_placement_and_state_dict():
    jm, tm = _pair("llama")
    names = [(n, tuple(p.shape)) for n, p in jm.named_parameters()]
    assert [(n, tuple(p.shape)) for n, p in tm.named_parameters()] == names
    assert list(tm.state_dict()) == [n for n, _ in names]
    q = tm.model.layers[0].self_attn.q_proj
    assert [n for n, _ in torch.nn.Module.named_parameters(q)] == \
        ["weight_mp0", "weight_mp1"]
    assert all(s.device == torch.device("cpu") for s in q.shards("weight"))
    held = sum(p.numel() for p in tm.shard_parameters())
    assert held == tm.num_params() == jm.num_params()
    # a state_dict round trip is exact, into a model of another seed
    other = LlamaForCausalLM(llama_tiny(tensor_parallel=True), seed=7,
                             device="cpu")
    other.load_state_dict(tm.state_dict())
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), n
    st = _state(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), st[n])


def test_views_are_copies_and_the_shards_are_held():
    """A logical view is a read-only copy: writing into it leaves the
    model as it was. What the model holds is ``shard_parameters()``:
    ``TrainStep`` refuses an optimizer that lacks a shard, the module's
    ``requires_grad_`` reaches every shard, and ``load_numpy_state``
    loads a sharded weight into its shards."""
    from paddle_tpu_torch.optimizer import SGD
    _meshes(2)
    tm = LlamaForCausalLM(llama_tiny(tensor_parallel=True), seed=2,
                          device="cpu")
    name = "model.layers.0.mlp.down_proj.weight"
    before = dict(tm.named_parameters())[name].detach().clone()
    with torch.no_grad():
        dict(tm.named_parameters())[name].zero_()
    assert torch.equal(dict(tm.named_parameters())[name], before)
    shards = list(tm.shard_parameters())
    with pytest.raises(ValueError, match="must come from the model"):
        TrainStep(tm, tm.loss, SGD(learning_rate=0.1,
                                   parameters=shards[:-1]))
    TrainStep(tm, tm.loss, SGD(learning_rate=0.1, parameters=shards))
    tm.requires_grad_(False)
    assert not any(p.requires_grad for p in tm.shard_parameters())
    state = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    state[name] = np.arange(before.numel(), dtype=np.float32) \
        .reshape(before.shape)
    tm.load_numpy_state(state)
    down = tm.model.layers[0].mlp.down_proj
    rows = before.shape[0] // 2
    for r, w in enumerate(down.shards("weight")):
        np.testing.assert_array_equal(w.detach().numpy(),
                                      state[name][r * rows:(r + 1) * rows])


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_one_seed_one_model_at_every_mp(family):
    _, _, tcls, tcfg = _FAMILIES[family]
    cfg = tcfg(tensor_parallel=True)
    one = tcls(cfg, seed=4, device="cpu")
    _meshes(2)
    two = tcls(cfg, seed=4, device="cpu")
    for (n, a), (m, b) in zip(one.named_parameters(),
                              two.named_parameters()):
        assert n == m and torch.equal(a, b), n
    ids = torch.as_tensor(_ids(512, s=8))
    _close(two(ids).detach().numpy(), one(ids).detach().numpy(),
           f"{family} mp 2 vs mp 1")


@pytest.mark.parametrize("clip", ["norm", "global_norm"])
def test_clips_over_shards_equal_the_plain_model(clip):
    """A shard's clip reads its logical parameter: ClipGradByNorm norms
    each logical parameter over all of its shards, and the global norm
    sums every shard once. One clipped SGD step at mp 2 equals the same
    step at mp 1 (the same seed, so the same logical weights). SGD, as
    its step is linear in the clipped grad; Adam's first step is
    g / (|g| + eps), which turns a grad near eps's size into noise."""
    from paddle_tpu_torch.optimizer import (SGD, ClipGradByGlobalNorm,
                                            ClipGradByNorm)
    ids = torch.as_tensor(_ids(512, s=8))
    models, clips = [], []
    for mp in (1, 2):
        if mp > 1:
            _meshes(mp)
        m = LlamaForCausalLM(llama_tiny(tensor_parallel=True), seed=5,
                             device="cpu")
        c = ClipGradByNorm(0.05) if clip == "norm" \
            else ClipGradByGlobalNorm(0.1)
        TrainStep(m, m.loss, SGD(learning_rate=0.5,
                                 parameters=m.named_parameters(),
                                 grad_clip=c))(ids, ids)
        models.append(m)
        clips.append(c)
    if clip == "global_norm":
        _close(float(clips[1].last_global_norm),
               float(clips[0].last_global_norm), "global norm")
    start = dict(LlamaForCausalLM(llama_tiny(), seed=5,
                                  device="cpu").named_parameters())
    for (n, a), (_, b) in zip(models[1].named_parameters(),
                              models[0].named_parameters()):
        _close(a.detach().numpy(), b.detach().numpy(), f"{clip} {n}")
        assert not torch.equal(a, start[n]), f"{n} did not move"
