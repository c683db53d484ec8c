"""The port's GPT family against the JAX package on the CPU: the model
(``models/gpt.py``) and the paged decoder's programs
(``inference/gpt_decode.py``).

The JAX ``GPTForCausalLM(gpt_tiny())`` is built from ``paddle.seed(0)``
and its ``named_parameters()`` are carried into the port's model by
``load_numpy_state``; the JAX ``PagedGPTDecoder`` of that model gives
its ``weights`` tree to the port's ``PagedGPTDecoder.from_numpy_weights``.
Tolerances:
- the forward's logits within 1e-5 of the largest |logit| (float32;
  the tied head's logits reach ~100) and the loss within 1e-5; the tied
  and untied heads;
- five ``TrainStep``s with ``AdamW(1e-3)``: losses within rtol 1e-4 at
  every step, falling;
- ``gpt_tiny(dtype="bfloat16")``: logits within one bfloat16 ulp of the
  largest |logit| (2**-7 of it), as Llama's bf16 case is held;
- chunked cross entropy: the loss within rtol 1e-5 of the dense loss and
  of JAX's chunked loss;
- recompute at each granularity: loss rtol 1e-5 and grads rtol 1e-6 of
  the plain forward; an unknown granularity and ``tensor_parallel``
  raise;
- ``layer_norm`` and ``gelu`` against JAX's on random inputs (float32
  1e-6; bfloat16 bit for bit, the exact GELU only);
- decoder programs (``_prefill_impl``, ``_prefill_prefix_impl`` and its
  no-logits chunk form, ``_decode_logits``, ``_ragged_logits``) from the
  same pools: logits within 1e-5 of the largest |logit|, pools within
  1e-5 except the scratch page; at ``hidden_size=256`` (head_dim 64)
  too; ``generate`` token for token with float32, int8 and int4
  weights, and from the port's own model through ``from_model``.
On the CPU the port's attention runs the plain versions of its kernels.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.inference.gpt_decode import \
    PagedGPTDecoder as JaxDecoder  # noqa: E402
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT  # noqa: E402
from paddle_tpu.models.gpt import gpt_tiny as jax_tiny  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.inference import PagedGPTDecoder  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import (  # noqa: E402
    GPTForCausalLM, ernie_45_dense_3b, gpt_345m, gpt_tiny)
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402

NB, BS, SCRATCH = 40, 8, 39


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(vocab, b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(b, s)).astype(np.int32)


def _pair(**kw):
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(**kw))
    tm = GPTForCausalLM(gpt_tiny(**kw), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _close_to_scale(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * max(1.0, np.abs(want).max()),
                               rtol=0)


# -- functionals --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_match_jax(dtype):
    from paddle_tpu.nn import functional as JF
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 32) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    jx = paddle.to_tensor(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jl = JF.layer_norm(jx, 32, paddle.to_tensor(w), paddle.to_tensor(b))
    tl = pnn.functional.layer_norm(tx, 32, torch.from_numpy(w),
                                   torch.from_numpy(b))
    jg, tg = JF.gelu(jx), pnn.functional.gelu(tx)
    ja = JF.gelu(jx, approximate=True)
    ta = pnn.functional.gelu(tx, approximate=True)
    tol = 1e-6 if dtype == "float32" else 0.0
    # the tanh form (on no path of the port) rounds elsewhere in bf16
    cases = [(jl, tl), (jg, tg)] + ([(ja, ta)] if dtype == "float32"
                                    else [])
    for j, t in cases:
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j._value, np.float32),
                                   atol=tol, rtol=tol)


def test_layer_norm_layer_defaults():
    ln = pnn.LayerNorm(8, device="cpu")
    assert ln.weight.dtype == torch.float32 and ln.bias.dtype == torch.float32
    assert bool((ln.weight == 1).all()) and bool((ln.bias == 0).all())
    assert pnn.LayerNorm(8, bias_attr=False, device="cpu").bias is None


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("tied", [True, False])
def test_forward_and_loss_match_jax(tied):
    jm, tm = _pair(tie_word_embeddings=tied)
    assert [n for n, _ in jm.named_parameters()] == \
        [n for n, _ in tm.named_parameters()]
    assert (tm.lm_head is None) == tied
    ids = _ids(512)
    jl = jm(paddle.to_tensor(ids))
    tl = tm(torch.as_tensor(ids))
    _close_to_scale(tl.detach().numpy(), jl._value, 1e-5)
    j_loss = float(jm.loss(jl, paddle.to_tensor(ids))._value)
    t_loss = float(tm.loss(tl, torch.as_tensor(ids)).detach())
    np.testing.assert_allclose(t_loss, j_loss, atol=1e-5)
    assert tm.num_params() == sum(int(np.prod(p.shape))
                                  for p in jm.parameters())


@pytest.mark.parametrize("tied", [True, False])
def test_inert_tensor_parallel_matches_jax(tied):
    """tensor_parallel=True with no fleet mesh is the plain model, as
    JAX's _mp_active() gating makes it: JAX's logits, loss and grads."""
    jm, tm = _pair(tensor_parallel=True, tie_word_embeddings=tied)
    ids = _ids(512)
    jstep = paddle.jit.TrainStep(
        jm, lambda o, l: jm.loss(o, l),
        jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()))
    params = [p._value for p in jstep._p_tensors]
    j_logits, _ = jax.jit(
        lambda ps, x: paddle.jit.functional_call(jm, ps, [], (x,)))(
        params, ids)
    j_loss, _, j_grads = jax.jit(jstep._make_loss_and_grads())(
        params, [], jax.random.PRNGKey(0), (ids,), (ids,))
    tx = torch.as_tensor(ids)
    t_logits = tm(tx)
    t_loss = tm.loss(t_logits, tx)
    t_loss.backward()
    _close_to_scale(t_logits.detach().numpy(), j_logits, 1e-5)
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=1e-5)
    t_grads = dict(tm.named_parameters())
    for name, g in zip(jstep._param_names, j_grads):
        _close_to_scale(t_grads[name].grad.numpy(), g, 1e-4)


def test_train_steps_match_jax():
    jm, tm = _pair()
    ids = _ids(512)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, lambda o, l: jm.loss(o, l), jo)
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tstep = TrainStep(tm, lambda o, l: tm.loss(o, l), to)
    jx, tx = paddle.to_tensor(ids), torch.as_tensor(ids)
    j_losses = [float(jstep(jx, jx)) for _ in range(5)]
    t_losses = [float(tstep(tx, tx)) for _ in range(5)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]


def test_bf16_logits_within_one_ulp():
    jm, tm = _pair(dtype="bfloat16", tie_word_embeddings=False)
    ids = _ids(512)
    jl = np.asarray(jm(paddle.to_tensor(ids))._value, np.float32)
    tl = tm(torch.as_tensor(ids)).detach().float().numpy()
    assert np.abs(tl - jl).max() <= 2.0 ** -7 * np.abs(jl).max()


def test_chunked_ce_matches_dense_and_jax():
    """JAX ``test_chunked_ce_gpt_and_moe``: the chunked loss of a tied
    model equals its dense loss, and JAX's dense loss on the same
    weights."""
    jm, td = _pair()
    tc = GPTForCausalLM(gpt_tiny(chunked_ce_tokens=16), device="cpu")
    tc.load_numpy_state({n: p.detach().numpy()
                         for n, p in td.named_parameters()})
    ids = _ids(512)
    tx = torch.as_tensor(ids)
    with torch.no_grad():
        l_d = float(td.loss(td(tx), tx))
        l_c = float(tc.loss(tc(tx), tx))
    jx = paddle.to_tensor(ids)
    j_d = float(jm.loss(jm(jx), jx)._value)
    np.testing.assert_allclose(l_c, l_d, rtol=1e-5)
    np.testing.assert_allclose(l_c, j_d, rtol=1e-5)


def test_recompute_granularities_equal_plain():
    """JAX ``TestRecomputeGranularityGPTMoE``: every granularity gives
    the plain forward's loss and grads."""
    from paddle_tpu_torch.models import GPTConfig
    outs = {}
    for gran in (None, "full", "full_attn", "core_attn"):
        cfg = GPTConfig(vocab_size=128, hidden_size=32,
                        intermediate_size=64, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=64,
                        use_recompute=gran is not None,
                        recompute_granularity=gran or "full")
        m = GPTForCausalLM(cfg, seed=21, device="cpu")
        tx = torch.as_tensor(_ids(128, s=12, seed=4))
        loss = m.loss(m(tx), tx)
        loss.backward()
        outs[gran] = (float(loss), {n: p.grad.clone()
                                    for n, p in m.named_parameters()})
    base_l, base_g = outs[None]
    for gran, (v, grads) in outs.items():
        np.testing.assert_allclose(v, base_l, rtol=1e-5)
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), base_g[n].numpy(),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{gran} {n}")
    cfg = gpt_tiny(use_recompute=True, recompute_granularity="bogus")
    m = GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="recompute_granularity"):
        m(torch.as_tensor(_ids(512, s=4)))


def test_unported_options_raise():
    # tensor_parallel is ported; under an mp mesh the heads must divide
    from paddle_tpu_torch.distributed import fleet as tfleet
    strategy = tfleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 3}
    tfleet.init(strategy=strategy, devices=["cpu"] * 3)
    try:
        with pytest.raises(ValueError, match="must divide"):
            GPTForCausalLM(gpt_tiny(tensor_parallel=True, vocab_size=513),
                           device="cpu")
    finally:
        tfleet._hcg = tfleet._strategy = None
    with pytest.raises(NotImplementedError, match="dropout"):
        GPTForCausalLM(gpt_tiny(hidden_dropout=0.1), device="cpu")


def test_configs_match_jax():
    from paddle_tpu.models import gpt as jgpt
    for tfn, jfn in ((gpt_tiny, jgpt.gpt_tiny), (gpt_345m, jgpt.gpt_345m),
                     (ernie_45_dense_3b, jgpt.ernie_45_dense_3b)):
        assert dataclasses.asdict(tfn()) == dataclasses.asdict(jfn())
    assert ernie_45_dense_3b().num_key_value_heads == 20


# -- the decoder's programs ---------------------------------------------------

def _dec_pair(weight_dtype=None, **cfg_kw):
    paddle.seed(0)
    # JAX's gpt_tiny fixes hidden_size itself: replace it afterwards
    jm = JaxGPT(dataclasses.replace(jax_tiny(), **cfg_kw))
    jm.eval()
    jdec = JaxDecoder(jm, num_blocks=NB, block_size=BS,
                      weight_dtype=weight_dtype)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = PagedGPTDecoder.from_numpy_weights(
        gpt_tiny(**cfg_kw), tree, weight_dtype=weight_dtype, num_blocks=NB,
        block_size=BS, device="cpu")
    return jm, jdec, tdec


@pytest.fixture(scope="module", params=[{}, {"hidden_size": 256}],
                ids=["d32", "d64"])
def dec_pair(request):
    return _dec_pair(**request.param)


def _pools(dec, seed=22):
    rng = np.random.RandomState(seed)
    cfg = dec.cfg
    shape = (NB, cfg.num_attention_heads, BS, dec.head_dim)
    return ([(rng.randn(*shape) * 0.5).astype(np.float32)
             for _ in range(cfg.num_hidden_layers)],
            [(rng.randn(*shape) * 0.5).astype(np.float32)
             for _ in range(cfg.num_hidden_layers)])


def _run_both(jdec, tdec, name, *args, jax_args=None, **kw):
    kp, vp = _pools(jdec)
    jl, jk, jv = jax.jit(getattr(jdec, name))(
        jdec.weights, [jnp.asarray(a) for a in kp],
        [jnp.asarray(a) for a in vp],
        *[jnp.asarray(a) for a in (jax_args or args)])
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    with torch.inference_mode():
        tl, tk2, tv2 = getattr(tdec, name)(
            tdec.weights, [tk], [tv], *[torch.from_numpy(a) for a in args],
            **kw)
    assert tk2[0] is tk and tv2[0] is tv
    return jl, tl, jk + jv, tk + tv


def _check(jl, tl, jpools, tpools):
    if tl is not None:
        _close_to_scale(tl.numpy(), jl, 1e-5)
    keep = [b for b in range(NB) if b != SCRATCH]
    for jp, tp in zip(jpools, tpools):
        np.testing.assert_allclose(tp.numpy()[keep], np.asarray(jp)[keep],
                                   atol=1e-5, rtol=0)


def _slots(rows):
    return np.asarray(rows, np.int32)


def test_prefill_matches_jax(dec_pair):
    _, jdec, tdec = dec_pair
    ids = _ids(512, 2, 12, seed=5)
    # row 0 takes blocks 0-1, row 1 blocks 2-3; row 1's last 4 are padding
    # aimed at the scratch page
    slots = _slots([list(range(0, 12)),
                    list(range(16, 24)) + [SCRATCH * BS] * 4])
    last = np.asarray([11, 7], np.int32)
    _check(*_run_both(jdec, tdec, "_prefill_impl", ids, slots, last))


def test_prefix_and_chunk_match_jax(dec_pair):
    _, jdec, tdec = dec_pair
    ids = _ids(512, 2, 8, seed=6)
    n_cached = np.asarray([16, 0], np.int32)
    slots = _slots([list(range(16, 24)), list(range(24, 32))])
    tables = np.asarray([[0, 1], [SCRATCH, SCRATCH]], np.int32)
    last = np.asarray([7, 5], np.int32)
    _check(*_run_both(jdec, tdec, "_prefill_prefix_impl", ids, slots, last,
                      n_cached, tables))
    # the no-logits chunk: JAX's _prefill_chunk_impl
    kp, vp = _pools(jdec)
    jk, jv = jax.jit(jdec._prefill_chunk_impl)(
        jdec.weights, [jnp.asarray(a) for a in kp],
        [jnp.asarray(a) for a in vp], jnp.asarray(ids), jnp.asarray(slots),
        jnp.asarray(n_cached), jnp.asarray(tables))
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    with torch.inference_mode():
        out, _, _ = tdec._prefill_prefix_impl(
            tdec.weights, [tk], [tv], torch.from_numpy(ids),
            torch.from_numpy(slots), None, torch.from_numpy(n_cached),
            torch.from_numpy(tables), logits=False)
    assert out is None
    _check(None, None, list(jk) + list(jv), tk + tv)


def test_decode_and_ragged_match_jax(dec_pair):
    _, jdec, tdec = dec_pair
    last = np.asarray([5, 9, 3], np.int32)
    ctx = np.asarray([13, 4, 0], np.int32)
    tables = np.asarray([[0, 1, 2], [3, 4, 5], [SCRATCH, SCRATCH, SCRATCH]],
                        np.int32)
    slots = np.asarray([13, 3 * BS + 4, SCRATCH * BS], np.int32)
    _check(*_run_both(jdec, tdec, "_decode_logits", last, tables, ctx,
                      slots))
    # a ragged ministep: 3 prefill rows of seq 0 at 10..12, one decode
    # row of seq 1 at 4, one padding row
    ids = np.asarray([7, 8, 9, 10, 0], np.int32)
    pos = np.asarray([10, 11, 12, 4, 0], np.int32)
    rslots = np.asarray([10, 11, 12, 3 * BS + 4, SCRATCH * BS], np.int32)
    row_seq = np.asarray([0, 0, 0, 1, 2], np.int32)
    row_ctx = np.asarray([11, 12, 13, 5, 0], np.int32)
    _check(*_run_both(jdec, tdec, "_ragged_logits", ids, pos, rslots,
                      row_seq, row_ctx, tables))


def test_positions_past_the_table_are_clamped():
    """Padding rows past max_position_embeddings read the last position
    row instead of indexing out of range (JAX fills NaN in
    _decode_logits); real rows are unchanged."""
    _, jdec, tdec = _dec_pair()
    cfg = tdec.cfg
    k, v = _pools(jdec)
    tk = [[torch.from_numpy(a) for a in k]]
    tv = [[torch.from_numpy(a) for a in v]]
    with torch.inference_mode():
        lg, _, _ = tdec._decode_logits(
            tdec.weights, tk, tv, torch.tensor([1, 2], dtype=torch.int32),
            torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
            torch.tensor([3, cfg.max_position_embeddings + 7],
                         dtype=torch.int32),
            torch.tensor([3, SCRATCH * BS], dtype=torch.int32))
    assert torch.isfinite(lg).all()


@pytest.mark.parametrize("wd", [None, "int8", "int4"])
def test_generate_token_identical(wd):
    """JAX ``TestPagedGPTDecoder``: generate() through the port equals
    JAX's token for token, from JAX's tree and from the port's model."""
    jm, jdec, tdec = _dec_pair(wd)
    ids = np.random.RandomState(21).randint(0, 512, (2, 7)).astype(np.int32)
    want = np.asarray(jdec.generate(ids, max_new_tokens=8))
    free0 = tdec.cache.free_blocks
    timings = {}
    got = tdec.generate(ids, max_new_tokens=8, timings=timings)
    np.testing.assert_array_equal(got, want)
    assert tdec.cache.free_blocks == free0
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    tdec2 = PagedGPTDecoder.from_model(tm, num_blocks=NB, block_size=BS,
                                       weight_dtype=wd, device="cpu")
    np.testing.assert_array_equal(tdec2.generate(ids, max_new_tokens=8),
                                  want)


def test_from_config_gains_ones_biases_drawn():
    dec = PagedGPTDecoder.from_config(gpt_tiny(), seed=3, num_blocks=8,
                                      block_size=8, device="cpu")
    lw = dec.weights[0]["layers"][0]
    assert bool((lw["ln1_w"] == 1).all()) and bool((dec.weights[0]["lnf_w"]
                                                    == 1).all())
    assert float(lw["bqkv"].abs().sum()) > 0
    assert lw["wqkv"].shape == (128, 384)
    assert dec.cache.kv_heads == 4
    with pytest.raises(ValueError, match="tp_shard_map"):
        from paddle_tpu_torch.distributed import ProcessMesh
        PagedGPTDecoder.from_config(
            gpt_tiny(), mesh=ProcessMesh([0, 1], ["tp"],
                                         devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="tp_comm"):
        PagedGPTDecoder.from_config(gpt_tiny(), tp_comm="int8",
                                    device="cpu")
