#!/usr/bin/env python3
"""The int8-comm logits error of tensor-parallel serving, the port against
the JAX package, on the CPU at Llama-3-8B's widths.

Run from the root of the repository (no card needed; a few minutes at 32
layers, about 8 GB of memory):

    JAX_PLATFORMS=cpu python3 tools/tp_int8_probe.py [LAYERS]

Builds JAX's fully-manual tp-2 decoder from seed 0 (hidden 4096,
intermediate 14336, 32 / 8 heads, ``LAYERS`` layers, default 32; a vocab
of 8192 in place of 128256 to keep the head small; bfloat16, int4
weights) with fp32 and with int8 comm, carries its weights into the
port's tp-2 decoders (every shard on the CPU), runs one 60-token prefill
through each of the four, and prints one JSON line: each package's
largest int8-against-fp32 logit difference over the largest fp32 logit
(the relative error ``tests/test_tp_serving.py`` bounds by 0.02 on
llama_tiny), and the port's logits against JAX's under each comm mode.
It says whether the port's EQuARX collective is as accurate as the
reference's at this width and depth; ``chip_smoke.py`` serve-tp2-int4
reports the same ratio on the card.
"""
import json
import sys
import time

import numpy as np


def main():
    import jax
    try:
        jax.config.update("jax_num_cpu_devices", 2)
    except AttributeError:
        pass
    import torch
    from jax.sharding import Mesh

    from paddle_tpu.inference.paged_decode import \
        PagedLlamaDecoder as JaxDecoder
    from paddle_tpu.models import llama_tiny as jax_tiny
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.inference import PagedLlamaDecoder
    from paddle_tpu_torch.models import llama_tiny

    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    geom = dict(num_hidden_layers=layers, hidden_size=4096,
                intermediate_size=14336, num_attention_heads=32,
                num_key_value_heads=8, vocab_size=8192, dtype="bfloat16")
    pool = dict(num_blocks=4, block_size=64, weight_dtype="int4")
    ids = np.random.RandomState(0).randint(0, 8192, (1, 60)) \
        .astype(np.int32)
    t0 = time.perf_counter()
    logits, tree = {}, None
    for comm in ("fp32", "int8"):
        dec = JaxDecoder.from_config(
            jax_tiny(**geom), seed=0, mesh=Mesh(
                np.asarray(jax.devices()[:2]), ("tp",)),
            mp_axis="tp", tp_shard_map=True, tp_comm=comm, **pool)
        c = dec.cache
        c.allocate(0, ids.shape[1] + 1)
        slots = np.asarray([[c.extend(0) for _ in range(ids.shape[1])]],
                           np.int32)
        lg, c.k, c.v = dec._prefill(dec.weights, c.k, c.v, ids, slots)
        logits[f"jax_{comm}"] = np.asarray(lg, np.float32)[0]
        if tree is None:
            tree = jax.tree.map(np.asarray, dec.weights)
        del dec, c
    for comm in ("fp32", "int8"):
        dec = PagedLlamaDecoder.from_numpy_weights(
            llama_tiny(**geom), tree, int4_layout="interleaved",
            mesh=ProcessMesh([0, 1], ["tp"], devices=["cpu"] * 2),
            mp_axis="tp", tp_shard_map=True, tp_comm=comm, **pool)
        c = dec.cache
        c.allocate(0, ids.shape[1] + 1)
        slots = torch.as_tensor([[c.extend(0)
                                  for _ in range(ids.shape[1])]],
                                dtype=torch.int32)
        with torch.inference_mode():
            lg, _, _ = dec._prefill_impl(dec.weights, c.k, c.v,
                                         torch.from_numpy(ids), slots)
        logits[f"port_{comm}"] = lg[0].float().numpy()
        del dec, c

    def rel(a, b):
        return float(np.abs(logits[a] - logits[b]).max()
                     / np.abs(logits[b]).max())

    print(json.dumps({
        "layers": layers, "seconds": time.perf_counter() - t0,
        "jax_int8_vs_fp32_rel": rel("jax_int8", "jax_fp32"),
        "port_int8_vs_fp32_rel": rel("port_int8", "port_fp32"),
        "port_vs_jax_fp32_rel": rel("port_fp32", "jax_fp32"),
        "port_vs_jax_int8_rel": rel("port_int8", "jax_int8"),
        "argmax_equal": len({int(v.argmax()) for v in logits.values()})
        == 1}))


if __name__ == "__main__":
    main()
