"""Tensor ops of the port. Modules that hold a kernel dispatch by the
tensor's device: a CUDA tensor goes to the hand-written kernel under
``ops/cuda/`` (or the call raises), a CPU tensor to the plain PyTorch
version beside it."""
