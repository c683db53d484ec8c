"""Helpers shared by the port's serving tests: the first-divergence
report for greedy streams held against the JAX engine, and a JAX
tensor-parallel decoder with the port's twin over its weights."""
import numpy as np
import pytest
import torch


def prompts(rng, lengths, vocab=512):
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def logits_after(tdec, tokens):
    """The port's logits for the next token after `tokens` (one prefill
    ministep over a fresh allocation)."""
    cache = tdec.cache
    n = len(tokens)
    cache.allocate(10_000, n)
    slots = [cache.extend(10_000) for _ in range(n)]
    table = torch.from_numpy(cache.block_table(10_000, tdec.max_pages)[None])
    pos = torch.arange(n, dtype=torch.int32)
    with torch.inference_mode():
        lg, _, _ = tdec._ragged_logits(
            tdec.weights, cache.k, cache.v,
            torch.as_tensor(tokens, dtype=torch.int32), pos,
            torch.as_tensor(slots, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32), pos + 1, table)
    cache.free(10_000)
    return lg[-1]


def assert_identical(tdec, reqs, port, ref):
    """Fail with the port's logit gap between the two tokens at the first
    divergence of any request's stream."""
    for (prompt, _), a, b in zip(reqs, port, ref):
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if i < min(len(a), len(b)):
            lg = logits_after(tdec, list(prompt) + a[:i])
            gap = float(lg[a[i]] - lg[b[i]])
            why = (f"first divergence at token {i}: port {a[i]} vs jax "
                   f"{b[i]}, port logit gap {gap:.3e}")
        else:
            why = f"lengths differ: port {len(a)} vs jax {len(b)}"
        pytest.fail(f"greedy streams differ ({why})\nport {a}\njax  {b}")


def tp_pair(n, jax_cfg, torch_cfg, **pool):
    """JAX's fully-manual tp-n decoder from a seeded config (its weights
    per projection, int4 interleaved) on the first n virtual devices,
    and the port's tp-n decoder over its numpy tree, every shard on the
    CPU. ``pool``: the decoders' pool and weight arguments."""
    import jax
    from jax.sharding import Mesh
    from paddle_tpu.inference.paged_decode import \
        PagedLlamaDecoder as JaxDecoder
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.inference import PagedLlamaDecoder
    jdec = JaxDecoder.from_config(
        jax_cfg, seed=0, mesh=Mesh(np.asarray(jax.devices()[:n]), ("tp",)),
        mp_axis="tp", tp_shard_map=True, **pool)
    tree = jax.tree.map(np.asarray, jdec.weights)
    tdec = PagedLlamaDecoder.from_numpy_weights(
        torch_cfg, tree, int4_layout="interleaved",
        mesh=ProcessMesh(list(range(n)), ["tp"], devices=["cpu"] * n),
        mp_axis="tp", tp_shard_map=True, **pool)
    return jdec, tdec
