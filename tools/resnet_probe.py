#!/usr/bin/env python3
"""Time bench.py's resnet row three ways on one CUDA card.

Run from the root of the repository:  python3 tools/resnet_probe.py

The row as chip_smoke.py's train-resnet50 builds it (ResNet-50 from seed
0, every parameter cast to bf16, float32 running stats, Momentum(0.1,
0.9), cross entropy in float32, b 256 x 3 x 224 x 224 bf16 from
RandomState(0)), one model per variant:
- ``nchw``: as the smoke runs it;
- ``channels_last``: the model and the input in torch.channels_last
  memory format (the same logical NCHW tensors; cuDNN then needs no
  layout transposes);
- ``cudnn_benchmark``: NCHW with torch.backends.cudnn.benchmark on.
The variants run in turns, three rounds of 2 warm + 5 timed steps each
(median step ms per variant), then one profiled step each (device ms by
family, the top kernels, the idle share, the step's peak memory). Also
printed: the BatchNorm layers' activations (elements a picture, from forward hooks) and the
least time one fused BatchNorm(+ReLU) pass per layer could take at b
256: bf16, 10 bytes an element (forward: read x, write y; backward: read
x and dy, write dx) over 3.35 TB/s. One JSON line per result; the
card's name and power limit first.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

VARIANTS = ("nchw", "channels_last", "cudnn_benchmark")


def _bn_elements(torch, model, size):
    """Elements a picture entering the model's BatchNorm layers (eval
    mode, batch 1, so the running stats stay)."""
    total = [0]

    def hook(mod, inp, out):
        total[0] += inp[0].numel()
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if type(m).__name__ == "BatchNorm2D"]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size, device="cuda"))
    model.train()
    for h in hooks:
        h.remove()
    return total[0]


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("resnet_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import HBM_BYTES_PER_S, _device_breakdown
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "nvidia_smi": smi}),
          flush=True)
    b = 256
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(b, 3, 224, 224).astype(np.float32),
                        device="cuda").to(torch.bfloat16)
    y = torch.as_tensor(rng.randint(0, 1000, b).astype(np.int64),
                        device="cuda")
    runs = {}
    for v in VARIANTS:
        model = resnet50(num_classes=1000, seed=0, device="cuda")
        if v == "nchw":
            n_bn = _bn_elements(torch, model, 224)
            print(json.dumps({
                "bn_elements_per_img": n_bn,
                "bn_fused_bound_ms": 1e3 * 10 * n_bn * b / HBM_BYTES_PER_S,
                "nvidia_smi": smi}), flush=True)
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
        xv = x
        if v == "channels_last":
            model = model.to(memory_format=torch.channels_last)
            xv = x.contiguous(memory_format=torch.channels_last)
        step = TrainStep(model, lambda o, l: F.cross_entropy(o.float(), l),
                         Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=model.parameters()))
        runs[v] = dict(step=step, x=xv, ms=[])

    def run(v, n):
        torch.backends.cudnn.benchmark = v == "cudnn_benchmark"
        r = runs[v]
        losses = [r["step"](r["x"], y) for _ in range(n)]
        torch.cuda.synchronize()
        return [float(l_) for l_ in losses]

    for _round in range(3):
        for v in VARIANTS:
            run(v, 2)
            t0 = time.perf_counter()
            losses = run(v, 5)
            runs[v]["ms"].append((time.perf_counter() - t0) * 1e3 / 5)
            if not all(np.isfinite(losses)):
                print(f"resnet_probe: {v} losses {losses}", file=sys.stderr)
                return 1
    for v in VARIANTS:
        med = statistics.median(runs[v]["ms"])
        torch.backends.cudnn.benchmark = v == "cudnn_benchmark"
        torch.cuda.reset_peak_memory_stats()
        prof = _device_breakdown(
            torch, lambda: runs[v]["step"](runs[v]["x"], y), med)
        print(json.dumps({"variant": v, "step_ms": runs[v]["ms"],
                          "median_step_ms": med,
                          "imgs_per_s": b * 1e3 / med,
                          "peak_mem_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                          "step_profile": prof, "nvidia_smi": smi}),
              flush=True)
    torch.backends.cudnn.benchmark = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
