#!/usr/bin/env python3
"""The int8-comm logits error of the port's tensor-parallel decoder at
Llama-3-8B, on the card and on the CPU with the same weights.

Run from the root of the repository on a machine with one card (about
25 GB of host memory and a few minutes of CPU time for the CPU legs):

    python3 tools/tp_int8_port_probe.py [DEVICE ...]

``DEVICE`` defaults to ``cuda cpu``. The weights are ``chip_smoke.py``
serve-tp2-int4's: ``llama_3_8b(dtype="bfloat16")``, all 32 layers, int4
from ``PagedLlamaDecoder.from_config(seed=0)`` drawn on the card. They
are split back into the per-projection tree and copied to each device,
so every leg holds the same integer values and scales. On each device
three decoders (tp 1, tp 2 with fp32 comm, tp 2 with int8 comm; both
shards on that device) run serve-tp2-int4's comparison prefill
(serve-int4's first prompt, 272 tokens, in one ragged ministep). The
script prints a JSON line as each device's legs end and then one for
the whole: for each device the largest int8-against-
fp32 logit difference over the largest fp32 logit (the ratio the
reference bounds by 0.02 on llama_tiny), fp32 comm against tp 1, the
argmaxes and the seconds each prefill took; and the card's logits
against the CPU's under each decoder. Equal ratios on both devices mean
the ratio is the model's at these weights, not the card's int8 path.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch.distributed import ProcessMesh
from paddle_tpu_torch.inference import PagedLlamaDecoder
from paddle_tpu_torch.models import llama_3_8b
from paddle_tpu_torch.ops.qweight import QWeight


def per_projection(tree, cfg):
    """The fused serving tree split back into wq / wk / wv and wg / wu
    (column cuts of the quantized values and their scales)."""
    hd = cfg.hidden_size // cfg.num_attention_heads
    qkv = [cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd,
           cfg.num_key_value_heads * hd]
    gu = [cfg.intermediate_size] * 2

    def cols(w, sizes):
        return [QWeight(q.contiguous(), s.contiguous(), w.kind)
                for q, s in zip(torch.split(w.q, sizes, dim=1),
                                torch.split(w.scale, sizes, dim=0))]

    layers = []
    for lw in tree["layers"]:
        lw = dict(lw)
        lw["wq"], lw["wk"], lw["wv"] = cols(lw.pop("wqkv"), qkv)
        lw["wg"], lw["wu"] = cols(lw.pop("wgu"), gu)
        layers.append(lw)
    return {**tree, "layers": layers}


def to_device(tree, dev):
    def mv(w):
        if isinstance(w, QWeight):
            return QWeight(w.q.to(dev), w.scale.to(dev), w.kind)
        return w.to(dev)
    return {k: ([{kk: mv(vv) for kk, vv in lw.items()} for lw in v]
                if k == "layers" else mv(v)) for k, v in tree.items()}


def last_logits(dec, toks):
    """float32 logits after ``toks``: one ragged prefill ministep over a
    fresh allocation (chip_smoke.py's ``last_logits`` at rows = len)."""
    cache, n, dev = dec.cache, len(toks), dec.device
    cache.allocate(0, n)
    slots = torch.as_tensor([cache.extend(0) for _ in range(n)],
                            dtype=torch.int32, device=dev)
    table = torch.as_tensor(cache.block_table(0, dec.max_pages)[None],
                            device=dev)
    ids = torch.as_tensor(toks, dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        lg, _, _ = dec._ragged_logits(dec.weights, dec.cache.k, dec.cache.v,
                                      ids, pos, slots,
                                      torch.zeros_like(pos), pos + 1, table)
    cache.free(0)
    return lg[-1].float().cpu()


def main():
    devices = sys.argv[1:] or ["cuda", "cpu"]
    cfg = llama_3_8b(dtype="bfloat16")
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, cfg.vocab_size, int(n))
            for n in rng.randint(100, 601, 8)][0]
    pool = dict(weight_dtype="int4", block_size=64, num_blocks=8)
    t0 = time.perf_counter()
    dec1 = PagedLlamaDecoder.from_config(cfg, seed=0, device="cuda", **pool)
    tree = per_projection(dec1.weights[0], cfg)
    del dec1
    out = {"prompt_tokens": len(toks), "layers": cfg.num_hidden_layers}
    logits = {}
    for dev in devices:
        t = tree if dev == "cuda" else to_device(tree, dev)
        res = {}
        for name, kw in (
                ("tp1", dict(device=dev)),
                ("tp2_fp32", dict(tp_comm="fp32")),
                ("tp2_int8", dict(tp_comm="int8"))):
            if "device" not in kw:
                kw.update(mesh=ProcessMesh([0, 1], ["tp"],
                                           devices=[dev] * 2),
                          mp_axis="tp", tp_shard_map=True)
            dec = PagedLlamaDecoder(cfg, t, **pool, **kw)
            t1 = time.perf_counter()
            logits[(dev, name)] = last_logits(dec, toks)
            res[f"{name}_prefill_s"] = time.perf_counter() - t1
            res[f"{name}_argmax"] = int(logits[(dev, name)].argmax())
            del dec
        lf, li, l1 = (logits[(dev, n)] for n in ("tp2_fp32", "tp2_int8",
                                                  "tp1"))
        res["int8_vs_fp32_logits_rel"] = float((lf - li).abs().max()
                                               / lf.abs().max())
        res["fp32_vs_tp1_logits_rel"] = float((lf - l1).abs().max()
                                              / l1.abs().max())
        res["fp32_logits_absmax"] = float(lf.abs().max())
        out[dev] = res
        print(json.dumps({dev: res}), flush=True)
        del t
    if len(devices) > 1:
        a, b = devices[:2]
        out[f"{a}_vs_{b}_logits_rel"] = {
            n: float((logits[(a, n)] - logits[(b, n)]).abs().max()
                     / logits[(b, n)].abs().max())
            for n in ("tp1", "tp2_fp32", "tp2_int8")}
    out["seconds"] = time.perf_counter() - t0
    if torch.cuda.is_available():
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
