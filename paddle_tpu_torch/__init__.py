"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu's serving path.

The package mirrors the module paths of ``paddle_tpu`` (``ops/``,
``models/``, ``inference/``) so each port module sits beside its JAX
counterpart's name. It imports ``torch`` and ``numpy`` only: never JAX
and nothing of ``paddle_tpu``. The kernels that the JAX package wrote in
Pallas for the TPU are CUDA C++ for Hopper here (``csrc/``), built at
first use by ``ops/cuda/_build.py`` — importing the package builds and
loads nothing.

Device rule: every entry point takes ``device=None``, which means
``cuda``; without a card it raises unless ``device="cpu"`` is asked for
(see ``device.resolve_device``). On the CPU each kernel's plain PyTorch
version runs in its place.
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
