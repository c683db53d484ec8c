"""The threefry2x32 key stream of ``jax.random``, bit for bit.

Counterpart: the ``jax.random`` functions the serving engine calls
(``paddle_tpu/inference/serving.py`` ``_next_key``, ``_sample``,
``_sample_rich``), in JAX's default configuration: the ``threefry2x32``
implementation with ``jax_threefry_partitionable`` on. The forms follow
the installed JAX source:

- ``jax/_src/prng.py``: ``threefry_2x32`` and ``_threefry2x32_lowering``
  (the 20 rounds, rotations 13/15/26/6 and 17/29/16/24, key injection
  every 4 rounds with ``k1 ^ k2 ^ 0x1BD11BDA``); ``_threefry_seed``
  (``PRNGKey``); ``_threefry_split_foldlike`` (``split``: the key
  hashed at counts ``(hi, lo)`` of the element index); ``_threefry_fold_in``
  (``fold_in``: the key hashed at the count pair ``(0, data)``);
  ``_threefry_random_bits_partitionable`` with ``iota_2x32_shape`` (32
  bits of element ``i`` are ``b1 ^ b2`` of the hash at count ``(i >>
  32, i & 0xFFFFFFFF)``, ``i`` the row-major element index, so element
  ``(r, j)`` of a ``[W, V]`` draw does not depend on ``W``).
- ``jax/_src/random.py``: ``_uniform`` (mantissa bits ``>> 9``, ``|
  0x3F800000``, bitcast, ``- 1.0``, then ``* (maxval - minval) +
  minval`` and ``max(minval, .)`` as separate IEEE float32 operations),
  ``_gumbel`` in its default mode (``-log(-log(uniform(minval=tiny,
  maxval=1)))``, not ``"high"``) and ``categorical`` (``argmax(gumbel +
  logits)`` along the last axis).

Keys are numpy ``uint32`` pairs handled on the host (``PRNGKey``,
``split``, ``fold_in``: a few hashes each). Bits for a draw are made on
the logits' device as integer tensor ops over int64 lanes masked to 32
bits: an int32 ``>>`` is arithmetic, and ``torch.uint32`` has few
operations on CUDA. The bits equal JAX's exactly on every device, and
so do the uniforms on a range of width 1, which is all the sampler
draws (on another range XLA on the CPU fuses the scale and the shift
into one multiply-add and may differ in the last bit). The Gumbel
noise differs from XLA's by the last bits of
``log`` (about 1e-6 at a float32 Gumbel of 8), so a sampled token can
differ only where two tempered logits lie within that of each other.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "fold_in", "threefry_2x32", "random_bits",
           "uniform", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# -- the hash, on numpy uint32 (keys) and on torch int64 lanes (bits) ----------
def _threefry_np(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) of the count pairs ``(x0, x1)`` (uint32
    arrays of one shape) under the key ``(k1, k2)``."""
    k1 = np.uint32(k1)
    k2 = np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(_PARITY)))
    x = [np.asarray(x0, np.uint32) + ks[0],
         np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _threefry_torch(k1, k2, x0, x1):
    """The same hash over int64 tensors holding uint32 values; ``k1`` /
    ``k2`` are 0-d int64 tensors (or ints). Every result is masked back
    to 32 bits, so each lane stays an exact uint32."""
    k3 = (k1 ^ k2 ^ _PARITY) & _M32
    ks = (k1, k2, k3)
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def threefry_2x32(key, count) -> np.ndarray:
    """``jax.random``'s ``threefry_2x32(key, count)``: the hash of a flat
    uint32 count array split in halves (padded to even length), on the
    host."""
    k1, k2 = (np.uint32(v) for v in np.asarray(key, np.uint32).reshape(2))
    count = np.asarray(count, np.uint32)
    flat = count.reshape(-1)
    odd = flat.size % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(1, np.uint32)])
    half = flat.size // 2
    a, b = _threefry_np(k1, k2, flat[:half], flat[half:])
    out = np.concatenate([a, b])
    return (out[:-1] if odd else out).reshape(count.shape)


# -- keys (host) ----------------------------------------------------------------
def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for an int seed: ``[seed >> 32, seed
    & 0xFFFFFFFF]`` as uint32. JAX (without x64) holds the seed as int32,
    whose logical shift by 32 is 0, so the high word of an int32 seed is
    0, negative seeds included."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _M32
    return np.array([hi, seed & _M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32, key ``i`` the hash
    of the count pair ``(i >> 32, i & 0xFFFFFFFF)``."""
    k = np.asarray(key, np.uint32).reshape(2)
    idx = np.arange(int(num), dtype=np.uint64)
    a, b = _threefry_np(k[0], k[1], (idx >> np.uint64(32)).astype(np.uint32),
                        (idx & np.uint64(_M32)).astype(np.uint32))
    return np.stack([a, b], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    ``(0, data)``."""
    return threefry_2x32(key, np.array([0, int(data) & _M32], np.uint32))


# -- draws (device) -------------------------------------------------------------
def _key_lanes(key, device):
    """A key (numpy uint32 pair, or an int32 / int64 tensor of 2) as two
    0-d int64 tensors on ``device`` holding its uint32 words."""
    if isinstance(key, torch.Tensor):
        k = key.reshape(2).to(device=device, dtype=torch.int64) & _M32
    else:
        k = torch.from_numpy(
            np.asarray(key, np.uint32).reshape(2).astype(np.int64)).to(device)
    return k[0], k[1]


def random_bits(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` in the partitionable form:
    an int64 tensor of uint32 values, element ``i`` (row-major) from the
    hash of ``(i >> 32, i & 0xFFFFFFFF)``."""
    if device is None:
        device = key.device if isinstance(key, torch.Tensor) else "cpu"
    k1, k2 = _key_lanes(key, device)
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    a, b = _threefry_torch(k1, k2, idx >> 32, idx & _M32)
    return (a ^ b).reshape(tuple(int(s) for s in shape))


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # float32 scalars as Python numbers (no host-to-device copy, so a
    # CUDA graph can capture the draw), and two rounded operations, as
    # XLA runs them (no fused multiply-add)
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return (floats * scale + lo).clamp(min=lo)


def gumbel(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (the default "low"
    mode)."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, device)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    logits: int32 argmax of Gumbel noise plus the logits (the first
    index on a tie, as ``jnp.argmax``)."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical draws float32 Gumbel noise for "
                        f"float32 logits, got {logits.dtype}")
    g = gumbel(key, tuple(logits.shape), logits.device)
    return (g + logits).argmax(dim=-1).to(torch.int32)
