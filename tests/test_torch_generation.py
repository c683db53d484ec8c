"""The port's KV-cached forward, ``generate`` and beam search against the
JAX package on the CPU.

The JAX ``LlamaForCausalLM(llama_tiny())`` (float32, untied and tied) is
built from ``paddle.seed(0)`` and its ``named_parameters()`` carried into
the port's model by ``load_numpy_state``. Then:
- ``forward(ids, caches=, pos=)``: a 7-token prefill at position 0 and
  two one-token steps; logits within 1e-4 of JAX's (its compiled
  ``functional_call``, as its ``generate`` runs it), and the caches.
- ``generate``: greedy; sampled at temperature 0.8 with top_k, top_p and
  a repetition penalty from one seed; greedy with an eos id; all token
  for token equal to JAX's ``model.generate``.
- ``beam_search``: the workloads of ``tests/test_serving.py``
  ``TestBeamSearch`` (4 beams; 3 beams with a length penalty and an eos;
  an eos that stops the search), token for token equal to JAX's; and the
  sampling arguments refused under beams, as in JAX.
One torch thread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.jit import _collect, functional_call  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JaxLlama  # noqa: E402
from paddle_tpu.models import llama_tiny as jax_tiny  # noqa: E402
from paddle_tpu.models.generation import \
    beam_search as jax_beam_search  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny  # noqa: E402
from paddle_tpu_torch.models.generation import beam_search  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**kw))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    tm.load_numpy_state({n: np.asarray(p._value)
                         for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def untied():
    return _pair()


@pytest.fixture(scope="module")
def tied():
    return _pair(tie_word_embeddings=True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x._value)


@pytest.mark.parametrize("which", ["untied", "tied"])
def test_cached_forward_matches_jax(which, request):
    jm, tm = request.getfixturevalue(which)
    cfg = tm.cfg
    rng = np.random.RandomState(3)
    b, max_len = 2, 12
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (b, max_len, cfg.num_key_value_heads, hd)
    params, buffers = _collect(jm)
    pa = [p._value for _, p in params]
    ba = [x._value for _, x in buffers]
    fwd = jax.jit(lambda pa, ba, chunk, caches, pos: functional_call(
        jm, pa, ba, (chunk,), kwargs={"caches": caches, "pos": pos})[0])
    j_caches = [(jnp.zeros(shape), jnp.zeros(shape))
                for _ in range(cfg.num_hidden_layers)]
    t_caches = [(torch.zeros(shape), torch.zeros(shape))
                for _ in range(cfg.num_hidden_layers)]
    pos = 0
    for s in (7, 1, 1):
        ids = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
        j_logits, j_caches = fwd(pa, ba, ids, j_caches, jnp.int32(pos))
        with torch.no_grad():
            t_logits, t_caches = tm(torch.as_tensor(ids), caches=t_caches,
                                    pos=pos)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=1e-4)
        pos += s
    for (jk, jv), (tk, tv) in zip(j_caches, t_caches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


GENERATE = {
    "greedy": dict(max_new_tokens=8),
    "sampled": dict(max_new_tokens=8, temperature=0.8, top_k=40, top_p=0.9,
                    repetition_penalty=1.3, seed=5),
    "sampled_top_k": dict(max_new_tokens=6, temperature=1.5, top_k=3,
                          seed=11),
}


@pytest.mark.parametrize("which", ["untied", "tied"])
@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_jax(case, which, request):
    jm, tm = request.getfixturevalue(which)
    ids = np.random.RandomState(7).randint(
        0, tm.cfg.vocab_size, (2, 6)).astype(np.int32)
    kw = GENERATE[case]
    want = _np(jm.generate(paddle.to_tensor(ids), **kw))
    got = tm.generate(torch.as_tensor(ids), **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_matches_jax(untied):
    jm, tm = untied
    ids = np.random.RandomState(8).randint(
        0, tm.cfg.vocab_size, (2, 5)).astype(np.int32)
    free = tm.generate(torch.as_tensor(ids), max_new_tokens=4).numpy()
    eos = int(free[0, 6])          # row 0's second new token
    kw = dict(max_new_tokens=9, eos_token_id=eos)
    want = _np(jm.generate(paddle.to_tensor(ids), **kw))
    got = tm.generate(torch.as_tensor(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 7:] == eos).all()


BEAMS = {
    "beam4": dict(shape=(2, 6), num_beams=4, max_new_tokens=5),
    "beam3_alpha": dict(shape=(1, 5), num_beams=3, max_new_tokens=4,
                        length_penalty=1.0),
    "beam3_alpha_eos": dict(shape=(1, 5), num_beams=3, max_new_tokens=6,
                            length_penalty=1.0, eos_at=6),
    "beam3_eos_stop": dict(shape=(1, 5), num_beams=3, max_new_tokens=6,
                           eos_at=5),
}


@pytest.mark.parametrize("case", list(BEAMS))
def test_beam_search_matches_jax(case, untied):
    jm, tm = untied
    kw = dict(BEAMS[case])
    ids = np.random.RandomState(11).randint(
        0, tm.cfg.vocab_size, kw.pop("shape")).astype(np.int32)
    eos_at = kw.pop("eos_at", None)
    if eos_at is not None:
        probe = beam_search(tm, ids, num_beams=kw["num_beams"],
                            max_new_tokens=2).numpy()
        kw["eos_token_id"] = int(probe[0, eos_at])
    want = _np(jax_beam_search(jm, ids, **kw))
    got = beam_search(tm, ids, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_num_beams(tied):
    jm, tm = tied
    ids = np.random.RandomState(12).randint(
        0, tm.cfg.vocab_size, (1, 6)).astype(np.int32)
    want = _np(jm.generate(paddle.to_tensor(ids), max_new_tokens=4,
                           num_beams=4))
    got = tm.generate(torch.as_tensor(ids), max_new_tokens=4, num_beams=4)
    np.testing.assert_array_equal(got.numpy(), want)
    # one beam is greedy
    np.testing.assert_array_equal(
        beam_search(tm, ids, num_beams=1, max_new_tokens=4).numpy(),
        tm.generate(torch.as_tensor(ids), max_new_tokens=4).numpy())
    for knob in (dict(temperature=0.5), dict(top_k=3), dict(top_p=0.9),
                 dict(repetition_penalty=1.2)):
        with pytest.raises(ValueError, match="beam search"):
            tm.generate(torch.as_tensor(ids), num_beams=2, **knob)
