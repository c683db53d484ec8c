"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Nothing here builds or loads at import: ``_build.load_library`` runs
``nvcc`` on the first launch. Each wrapper checks its inputs, allocates
its output, launches on the current stream, raises on a non-zero launch
error and counts its launches in a module-level ``launches`` integer.
"""
