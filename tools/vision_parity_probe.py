"""Repeat tiny-vision-parity's three SqueezeNet 1.1 steps on the card.

Run from the repository root on a machine with a CUDA card:
    python3 tools/vision_parity_probe.py

SqueezeNet 1.1 (num_classes 10, seed 0, every Dropout's p 0), b 4 x 3 x
64 x 64 from RandomState(5), three TrainSteps of Momentum(0.01, 0.9) in
float32 with TF32 off, as chip_smoke.py's tiny-vision-parity runs them:
once on the CPU, then on the card fresh, again, while 74 GB of the card
are held, with cuDNN's deterministic algorithms and with cuDNN off.
Prints each run's losses, so the card's run-to-run spread can be read
beside its distance from the CPU."""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.optimizer import Momentum  # noqa: E402
from paddle_tpu_torch.vision import models  # noqa: E402


def losses(state, x_np, y_np, device):
    m = models.squeezenet1_1(num_classes=10, seed=1, device=device)
    m.load_state_dict(state)
    for d in m.modules():
        if isinstance(d, pnn.Dropout):
            d.p = 0.0
    x = torch.as_tensor(x_np, device=device)
    y = torch.as_tensor(y_np, device=device)
    step = TrainStep(m, lambda o, l: F.cross_entropy(o, l),
                     Momentum(learning_rate=0.01, momentum=0.9,
                              parameters=m.parameters()))
    return [float(step(x, y)) for _ in range(3)]


def main():
    if not torch.cuda.is_available():
        print("vision_parity_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(5)
    x_np = rng.randn(4, 3, 64, 64).astype(np.float32)
    y_np = rng.randint(0, 10, 4).astype(np.int64)
    state = models.squeezenet1_1(num_classes=10, seed=0,
                                 device="cpu").state_dict()
    print("device", torch.cuda.get_device_name(0))
    print("cpu", losses(state, x_np, y_np, "cpu"))
    print("cuda fresh", losses(state, x_np, y_np, "cuda"))
    print("cuda again", losses(state, x_np, y_np, "cuda"))
    hold = torch.empty(int(74e9), dtype=torch.uint8, device="cuda")
    print("cuda with 74 GB held", losses(state, x_np, y_np, "cuda"))
    del hold
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    print("cuda cudnn deterministic", losses(state, x_np, y_np, "cuda"))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.enabled = False
    print("cuda without cudnn", losses(state, x_np, y_np, "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
