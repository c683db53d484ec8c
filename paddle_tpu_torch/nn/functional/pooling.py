"""Pooling functionals. Counterpart: ``paddle_tpu/nn/functional/pooling.py``.

JAX pools with ``lax.reduce_window`` on XLA, not in Pallas, so the
port's route is torch's pooling ops (cuDNN or ATen on the card), as it
is for ``conv2d``. Padding is resolved exactly as ``_explicit_pads``
(:25-56) resolves it: an int, one int per spatial dim, per-side pairs,
``"SAME"`` / ``"VALID"``, and ``ceil_mode`` as extra high padding. It is
applied with ``F.pad`` (-inf for max, 0 for avg) and torch's pool then
runs with ``padding=0, ceil_mode=False``: torch's ``padding=`` is
symmetric only, and its ``ceil_mode`` drops a last window that starts in
the right padding, where JAX's keeps it.

- ``avg_*``: the window's sum over the kernel's size; with
  ``exclusive`` and some nonzero pad, over the count of the window's
  cells that are not padding (:83-91). ``divisor_override`` is accepted
  and ignored, as in JAX. A bfloat16 / float16 input is averaged in
  float32 and rounded once (torch's CPU pools would sum a 3-D window in
  bf16, or refuse it; JAX sums in the input's dtype).
- ``max_*(return_mask=True)`` (``_max_pool_indices`` :149-186): the
  flat row-major index of each window's first maximum into the
  unpadded spatial dims, int32; 0 where the maximum is not above the
  dtype's lowest finite value (a window of padding only).
- ``adaptive_*`` (``_adaptive`` :189-247): bins ``floor(i * in / o)``
  to ``ceil((i + 1) * in / o)``, torch's own; over the last n dims
  (``NHWC`` / ``NDHWC`` for the avg 2-D / 3-D forms move the channel);
  avg in float32 for a bf16 / float16 input, as above.
  JAX's adaptive max pools ignore ``return_mask``; the port raises on
  it (no mask is computed).
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _t(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(e) for e in v)


def _explicit_pads(padding, n, spatial, k, s, ceil_mode):
    """Paddle's padding forms (int, per-dim, pair list, "SAME" /
    "VALID") plus ceil_mode as explicit per-dim (lo, hi) pairs; ceil mode
    adds high padding so that ceil((in + p - k) / s) + 1 windows come
    out."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0)] * n
        else:  # SAME
            pads = []
            for i in range(n):
                out = -(-spatial[i] // s[i])
                total = max((out - 1) * s[i] + k[i] - spatial[i], 0)
                pads.append((total // 2, total - total // 2))
    else:
        p = _t(padding, n) if not isinstance(padding, (list, tuple)) or \
            all(isinstance(e, int) for e in padding) else padding
        if isinstance(p, tuple) and len(p) == n:
            pads = [(e, e) for e in p]
        else:
            pads = [tuple(e) for e in p]
    if ceil_mode:
        out = []
        for i in range(n):
            lo, hi = pads[i]
            eff = spatial[i] + lo + hi - k[i]
            out_c = -(-eff // s[i]) + 1
            extra = (out_c - 1) * s[i] + k[i] - (spatial[i] + lo + hi)
            out.append((lo, hi + max(extra, 0)))
        pads = out
    return pads


def _acc(x):
    """x in the dtype an average accumulates in."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _channel_first(x, n, channel_last):
    """x with its channel before the n spatial dims."""
    return torch.movedim(x, -1, -n - 1) if channel_last else x


def _channel_back(x, n, channel_last):
    return torch.movedim(x, -n - 1, -1) if channel_last else x


def _padded(x, pads, value):
    """x [..., *spatial] padded on its last len(pads) dims."""
    flat = [e for lo_hi in reversed(pads) for e in lo_hi]
    if not any(flat):
        return x
    return TF.pad(x, flat, value=value)


def _pool(x, kernel, stride, padding, n, channel_last, kind, ceil_mode,
          exclusive=True, return_mask=False):
    k = _t(kernel, n)
    s = _t(stride if stride is not None else kernel, n)
    a = _channel_first(x, n, channel_last)
    spatial = tuple(a.shape[-n:])
    pads = _explicit_pads(padding, n, spatial, k, s, ceil_mode)
    if kind == "max":
        low = -math.inf if a.dtype.is_floating_point \
            else torch.iinfo(a.dtype).min
        ap = _padded(a, pads, low)
        if not return_mask:
            return _channel_back(_MAX[n](ap, k, s), n, channel_last)
        out, idx = _MAX[n](ap, k, s, return_indices=True)
        mask = _unpadded_index(idx, out, ap.shape[-n:], spatial, pads)
        return (_channel_back(out, n, channel_last),
                _channel_back(mask, n, channel_last))
    ap = _padded(_acc(a), pads, 0.0)
    if n == 1:   # torch's 1-D avg pool takes no divisor: pool as 2-D
        summed = TF.avg_pool2d(ap.unsqueeze(-2), (1,) + k, (1,) + s,
                               divisor_override=1).squeeze(-2)
    else:
        summed = _AVG[n](ap, k, s, divisor_override=1)
    if exclusive and any(p != (0, 0) for p in pads):
        ones = _padded(torch.ones((1, 1) + spatial, dtype=ap.dtype,
                                  device=a.device), pads, 0.0)
        if n == 1:
            counts = TF.avg_pool2d(ones.unsqueeze(-2), (1,) + k, (1,) + s,
                                   divisor_override=1).squeeze(-2)
        else:
            counts = _AVG[n](ones, k, s, divisor_override=1)
        out = summed / counts.reshape(counts.shape[2:])
    else:
        out = summed / float(math.prod(k))
    return _channel_back(out.to(x.dtype), n, channel_last)


def _unpadded_index(idx, out, padded, spatial, pads):
    """torch's flat indices into the padded spatial dims -> flat indices
    into the unpadded ones (int32); 0 where the maximum is not above the
    lowest finite value, as JAX's argmax over (value, index) pairs gives
    (its init value, which padding also takes, wins ties)."""
    # unravel over the padded dims, ravel row-major over the unpadded
    flat = torch.zeros_like(idx)
    rest = idx
    stride = 1
    for size, unpadded, (lo, _hi) in reversed(list(zip(padded, spatial,
                                                       pads))):
        flat = flat + (rest % size - lo) * stride
        rest = rest // size
        stride *= unpadded
    if out.dtype.is_floating_point:
        real = out > torch.finfo(out.dtype).min
    else:
        real = out > torch.iinfo(out.dtype).min
    return torch.where(real, flat, torch.zeros_like(flat)).to(torch.int32)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL"):
    return _pool(x, kernel_size, stride, padding, 1, data_format == "NLC",
                 "max", ceil_mode, return_mask=return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                 "max", ceil_mode, return_mask=return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, 3,
                 data_format == "NDHWC", "max", ceil_mode,
                 return_mask=return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _pool(x, kernel_size, stride, padding, 1, data_format == "NLC",
                 "avg", ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                 "avg", ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, 3,
                 data_format == "NDHWC", "avg", ceil_mode, exclusive)


def _adaptive(x, output_size, n, kind, channel_last=False,
              return_mask=False):
    if return_mask:
        raise NotImplementedError(
            f"adaptive_{kind}_pool{n}d: return_mask is not ported (JAX's "
            f"ignores it)")
    o = _t(output_size, n)
    a = _channel_first(x, n, channel_last)
    lead, spatial = a.shape[:-n], a.shape[-n:]
    if kind == "avg":
        a = _acc(a)
    out = _ADAPTIVE[kind, n](a.reshape((-1, 1) + tuple(spatial)), o)
    return _channel_back(out.reshape(tuple(lead) + o).to(x.dtype), n,
                         channel_last)


def adaptive_avg_pool1d(x, output_size):
    return _adaptive(x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive(x, output_size, 2, "avg", data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive(x, output_size, 3, "avg", data_format == "NDHWC")


def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 1, "max", return_mask=return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 2, "max", return_mask=return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 3, "max", return_mask=return_mask)
