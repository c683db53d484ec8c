#!/usr/bin/env python3
"""Check and time the MoE FFN's grouped products on one CUDA card.

Run from the root of the repository:  python3 tools/moe_probe.py

For each expert geometry of bench.py's moe rows (T*k = 16,384 routed
rows; D 1024 / H 1408 / E 8, D 1024 / H 512 / E 64, D 2048 / H 2048 /
E 8), with group sizes from a seeded top-2 routing of random logits and
one empty expert, bf16:
- ``ops.moe._grouped_mm`` (``torch._grouped_mm``) forward and its
  autograd dX and dW against a ``torch.matmul`` per expert computed in
  float32 on the card: the largest error over the largest |reference|;
- the device ms (CUDA events, L2 flushed before each launch, 10
  launches) of the forward and of forward + backward of the grouped
  product and, as a yardstick, of a bf16 matmul per expert (its host
  read of the group sizes included), alternated twice;
then the whole FFN of each dispatch mode at bench.py's b 4 x s 2048, D
1024, E 8 of 1408, top-2, bf16: forward + backward device ms. Prints one
JSON line per case; the card's name and power limit first.
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

GEOMETRIES = [dict(name="e8_h1408", d=1024, h=1408, e=8),
              dict(name="e64_h512", d=1024, h=512, e=64),
              dict(name="e8_h2048_wide", d=2048, h=2048, e=8)]


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import _Timer
    from paddle_tpu_torch.ops import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "nvidia_smi": smi}),
          flush=True)
    timer = _Timer(torch)
    rng = np.random.RandomState(0)
    rows, k = 16384, 2
    for g in GEOMETRIES:
        d, h, e = g["d"], g["h"], g["e"]
        logits = rng.randn(rows // k, e).astype(np.float32)
        logits[:, 0] = -1e9                   # expert 0 gets no row
        top = np.argsort(-logits, axis=1, kind="stable")[:, :k]
        sizes = torch.as_tensor(np.bincount(top.reshape(-1), minlength=e),
                                device="cuda")
        x = (torch.randn(rows, d, device="cuda") * 0.5).to(torch.bfloat16)
        w = (torch.randn(e, d, h, device="cuda") / d ** 0.5).to(
            torch.bfloat16)
        dy = torch.randn(rows, h, device="cuda").to(torch.bfloat16)
        host = sizes.tolist()

        def loop(a, b_, ints=None):
            parts = torch.split(a, ints or sizes.tolist())
            return torch.cat([p @ b_[i] for i, p in enumerate(parts)])

        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = moe._grouped_mm(xg, wg, sizes)
        y.backward(dy)
        xr, wr = (t.float().requires_grad_() for t in (x, w))
        yr = loop(xr, wr, host)
        yr.backward(dy.float())
        err = {}
        for name, got, ref in (("y", y, yr), ("dx", xg.grad, xr.grad),
                               ("dw", wg.grad, wr.grad)):
            err[name] = float((got.float() - ref).abs().max().detach()
                              / ref.abs().max().detach())

        def fwd_bwd(fn):
            a, b_ = x.clone().requires_grad_(), w.clone().requires_grad_()
            return lambda: torch.autograd.grad(fn(a, b_), (a, b_), dy)

        grouped = lambda a, b_: moe._grouped_mm(a, b_, sizes)  # noqa: E731
        ms = {"grouped_fwd": [], "loop_fwd": [], "grouped_fwd_bwd": [],
              "loop_fwd_bwd": []}
        with torch.no_grad():
            for _ in range(2):
                ms["grouped_fwd"].append(timer(lambda: grouped(x, w)))
                ms["loop_fwd"].append(timer(lambda: loop(x, w)))
        for _ in range(2):
            ms["grouped_fwd_bwd"].append(timer(fwd_bwd(grouped)))
            ms["loop_fwd_bwd"].append(timer(fwd_bwd(loop)))
        flops = 2 * rows * d * h
        print(json.dumps(dict(g, rows=rows, group_sizes=host,
                              rel_err=err, ms=ms,
                              fwd_tflops=flops / (min(ms["grouped_fwd"])
                                                  * 1e-3) / 1e12,
                              nvidia_smi=smi)), flush=True)
        del x, w, dy, xg, wg, xr, wr, y, yr
        torch.cuda.empty_cache()

    b, s, d, h, e = 4, 2048, 1024, 1408, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, s, d, device="cuda", generator=gen).to(torch.bfloat16)
    gw = torch.randn(d, e, device="cuda", generator=gen) * 0.02
    w1 = torch.randn(e, d, h, device="cuda", generator=gen) / d ** 0.5
    w2 = torch.randn(e, h, d, device="cuda", generator=gen) / h ** 0.5
    dout = torch.randn(b, s, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    for mode, fn in (("dense", lambda *a: moe.moe_dispatch_combine(
            *a, k, 1.25)), ("ragged", lambda *a: moe.moe_ragged_forward(
                *a, k))):
        leaves = [t.clone().requires_grad_() for t in (x, gw, w1, w2)]

        def step():
            out, aux, _ = fn(*leaves)
            torch.autograd.backward((out, aux), (dout, torch.ones_like(aux)))

        step()
        print(json.dumps({"ffn": mode, "b": b, "s": s, "d": d, "h": h,
                          "e": e, "top_k": k, "fwd_bwd_ms": timer(step, 5),
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
