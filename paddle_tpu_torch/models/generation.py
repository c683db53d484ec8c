"""Autoregressive generation over static KV caches: ``generate`` and
``beam_search``. Counterpart: ``paddle_tpu/models/generation.py``
(``_sample``, ``_apply_repetition_penalty``, ``_setup_decode``,
``generate``, ``_lp_array``, ``beam_step``, ``beam_search``).

JAX compiles a prefill and a one-token decode step and replays the step;
here both are eager calls of ``LlamaForCausalLM.forward(ids, caches=,
pos=)``, whose caches are written in place. Keys follow JAX's stream
through ``utils/prng.py``: ``PRNGKey(seed)``, one ``split`` a step, and a
token is ``categorical(key, logits)``; a seeded stream is JAX's token
for token (a sampled token can differ only where two tempered logits lie
within the Gumbel noise's last bits of each other, ``utils/prng.py``).
``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
promises no order, so every ranking here is a stable descending sort.
A bfloat16 model's sampled stream draws float32 noise over its logits
cast to float32; JAX draws bfloat16 noise there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import prng

__all__ = ["generate", "beam_search", "beam_step"]


def _top(x, k: int):
    """``jax.lax.top_k`` along the last axis: values and indices, ties
    to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sample(logits, temperature, top_k, key, top_p=1.0):
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    neg = torch.full((), -1e30, device=logits.device)
    if top_k > 0:
        kth = _top(logits, top_k)[0][..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        # nucleus: the smallest prefix of the sorted distribution whose
        # mass reaches top_p (the top token always survives)
        sorted_logits = torch.sort(logits, dim=-1, descending=True)[0]
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = cum - probs > top_p
        kth_val = torch.where(cutoff, torch.full((), float("inf"),
                                                 device=logits.device),
                              sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < kth_val, neg, logits)
    return prng.categorical(key, logits)


def _apply_repetition_penalty(logits, seen_mask, penalty):
    """Already-seen tokens: positive logits divided by ``penalty``,
    negative ones multiplied."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def _setup_decode(model, input_ids, max_new_tokens, max_length):
    """Ids on the model's device, the new-token budget and one zeroed
    (k, v) cache pair a layer, [b, max_length, kv_heads, head_dim] in the
    model's compute dtype."""
    cfg = model.cfg
    dev = model.model.norm.weight.device   # a tp embedding is sharded
    if isinstance(input_ids, torch.Tensor):
        ids = input_ids.to(device=dev, dtype=torch.int32)
    else:
        ids = torch.as_tensor(np.asarray(input_ids, np.int32), device=dev)
    b, prompt_len = ids.shape
    max_length = max_length or min(cfg.max_position_embeddings,
                                   prompt_len + max_new_tokens)
    n_new = min(max_new_tokens, max_length - prompt_len)
    model.eval()
    shape = (b, max_length, cfg.num_key_value_heads,
             cfg.hidden_size // cfg.num_attention_heads)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    caches = [(torch.zeros(shape, dtype=dtype, device=dev),
               torch.zeros(shape, dtype=dtype, device=dev))
              for _ in range(cfg.num_hidden_layers)]
    return ids, b, prompt_len, n_new, caches


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int = 32,
             max_length: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, eos_token_id: Optional[int] = None,
             seed: int = 0, top_p: float = 1.0,
             repetition_penalty: float = 1.0):
    """[b, prompt_len + generated] int32 ids, the prompt included: greedy
    at temperature 0, else sampled with top_k / top_p filtering and the
    repetition penalty; a row that emits ``eos_token_id`` repeats it, and
    the loop ends when every row has."""
    cfg = model.cfg
    ids, b, prompt_len, n_new, caches = _setup_decode(
        model, input_ids, max_new_tokens, max_length)
    if n_new <= 0:
        return ids
    dev = ids.device
    rows = torch.arange(b, device=dev)

    def step(chunk, caches, pos, key, seen):
        logits, caches = model(chunk, caches=caches, pos=pos)
        last = _apply_repetition_penalty(logits[:, -1, :], seen,
                                         repetition_penalty)
        return _sample(last, temperature, top_k, key, top_p), caches

    # token-presence mask for the repetition penalty (prompt + generated)
    seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
    if repetition_penalty != 1.0:
        seen[rows[:, None], ids.long()] = True
    key = prng.PRNGKey(seed)
    key, k0 = prng.split(key)
    tok, caches = step(ids, caches, 0, k0, seen)
    out_tokens = [tok]
    pos = prompt_len
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    if eos_token_id is not None:
        finished = finished | (tok == eos_token_id)
    for _ in range(n_new - 1):
        if eos_token_id is not None and bool(finished.all()):
            break
        if repetition_penalty != 1.0:
            seen[rows, tok.long()] = True
        key, kd = prng.split(key)
        tok, caches = step(tok[:, None], caches, pos, kd, seen)
        if eos_token_id is not None:
            tok = torch.where(finished, torch.full_like(tok, eos_token_id),
                              tok)
            finished = finished | (tok == eos_token_id)
        out_tokens.append(tok)
        pos += 1
    return torch.cat([ids, torch.stack(out_tokens, dim=1)], dim=1)


def _lp_array(lengths, alpha):
    """The GNMT length penalty over a [b, nb] length array."""
    if alpha == 0.0:
        return torch.ones(lengths.shape, dtype=torch.float32,
                          device=lengths.device)
    return ((5.0 + lengths.float()) / 6.0) ** alpha


def beam_step(scores, logp, finished, eos_token_id, lengths=None,
              length_penalty=0.0):
    """One beam expansion: scores [b, nb], logp [b, nb, V], finished
    [b, nb], lengths [b, nb] (tokens generated, frozen at eos) ->
    (new_scores, beam_idx, tok_idx, new_finished, new_lengths).

    A finished beam continues by emitting eos at logp 0 with its length
    frozen. Candidates rank by score / lp(candidate length); the scores
    carried stay raw."""
    b, nb, vocab = logp.shape
    if lengths is None:
        lengths = torch.zeros((b, nb), dtype=torch.int32,
                              device=logp.device)
    if eos_token_id is not None:
        eos_row = torch.full((vocab,), -float("inf"), dtype=torch.float32,
                             device=logp.device)
        eos_row[eos_token_id] = 0.0
        logp = torch.where(finished[:, :, None], eos_row[None, None], logp)
    cand = scores[:, :, None] + logp
    # live beams grow by one, finished ones stay frozen
    cand_len = torch.where(finished, lengths, lengths + 1)
    rank = cand / _lp_array(cand_len, length_penalty)[:, :, None]
    _, top_idx = _top(rank.reshape(b, nb * vocab), nb)
    beam_idx = torch.div(top_idx, vocab, rounding_mode="floor")
    tok_idx = (top_idx % vocab).to(torch.int32)
    new_scores = torch.gather(cand.reshape(b, nb * vocab), 1, top_idx)
    new_finished = torch.gather(finished, 1, beam_idx)
    new_lengths = torch.gather(cand_len, 1, beam_idx)
    if eos_token_id is not None:
        new_finished = new_finished | (tok_idx == eos_token_id)
    return (new_scores, beam_idx.to(torch.int32), tok_idx, new_finished,
            new_lengths)


@torch.no_grad()
def beam_search(model, input_ids, num_beams: int = 4,
                max_new_tokens: int = 32, length_penalty: float = 0.0,
                eos_token_id: Optional[int] = None,
                max_length: Optional[int] = None):
    """Beam search over the KV caches: candidates ranked by cumulative
    log-probability under the GNMT length penalty; finished beams emit
    eos at logp 0; the search stops early when every beam has finished.
    Returns the best beam a row, [b, prompt_len + generated] int32."""
    nb = int(num_beams)
    ids, b, prompt_len, n_new, caches = _setup_decode(
        model, input_ids, max_new_tokens, max_length)
    if n_new <= 0:
        return ids
    dev = ids.device

    def log_probs(logits):
        return torch.log_softmax(logits[:, -1, :].float(), dim=-1)

    logits, caches = model(ids, caches=caches, pos=0)
    logp0 = log_probs(logits)
    vocab = logp0.shape[-1]
    # the caches tiled across beams: [b, ...] -> [b * nb, ...]
    caches = [tuple(c.repeat_interleave(nb, dim=0) for c in kv)
              for kv in caches]
    scores, toks = _top(logp0, nb)                     # [b, nb]
    toks = toks.to(torch.int32)
    history = toks[:, :, None]                         # [b, nb, 1]
    finished = torch.zeros((b, nb), dtype=torch.bool, device=dev)
    if eos_token_id is not None:
        finished = toks == eos_token_id
    lengths = torch.ones((b, nb), dtype=torch.int32, device=dev)
    beam_sel = torch.arange(b * nb, device=dev)
    pos = prompt_len
    for _ in range(1, n_new):
        if eos_token_id is not None and bool(finished.all()):
            break
        # each cache row follows its surviving parent beam, then a step
        caches = [tuple(c[beam_sel] for c in kv) for kv in caches]
        logits, caches = model(toks.reshape(b * nb, 1), caches=caches,
                               pos=pos)
        logp = log_probs(logits).reshape(b, nb, vocab)
        scores, beam_idx, toks, finished, lengths = beam_step(
            scores, logp, finished, eos_token_id, lengths, length_penalty)
        history = torch.cat(
            [torch.gather(history, 1, beam_idx.long()[:, :, None].expand(
                -1, -1, history.shape[2])), toks[:, :, None]], dim=2)
        beam_sel = (torch.arange(b, device=dev)[:, None] * nb
                    + beam_idx.long()).reshape(b * nb)
        pos += 1
    final_rank = scores / _lp_array(lengths, length_penalty)
    best = final_rank.argmax(dim=1)
    best_seq = history[torch.arange(b, device=dev), best]  # [b, gen_len]
    return torch.cat([ids, best_seq.to(torch.int32)], dim=1)
