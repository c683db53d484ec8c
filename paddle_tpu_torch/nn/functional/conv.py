"""``conv2d``. Counterpart: ``paddle_tpu/nn/functional/conv.py``
(``_conv`` :42-76, ``conv2d`` :79-82).

The weight is in paddle's layout [out, in / groups, kh, kw] and is cast
to x's dtype before the product; the bias is cast to the output's dtype
and added after it, as ``_conv`` does. JAX runs the convolution on XLA,
not in Pallas, so the port's route is ``torch.nn.functional.conv2d``
(cuDNN on the card). Ported: NCHW, stride, dilation and padding as an
int or one int per spatial dim (symmetric), groups. Other padding forms
("SAME", "VALID", per-side pairs) and NHWC raise."""
from __future__ import annotations

import torch

__all__ = ["conv2d"]


def _pair(v, what):
    if isinstance(v, int):
        return (v, v)
    v = tuple(v)
    if len(v) != 2 or not all(isinstance(e, int) for e in v):
        raise NotImplementedError(
            f"conv2d: {what} {v!r}: only an int or one int per spatial "
            f"dim is ported (ROADMAP queue 1, item 10(b))")
    return v


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """x [n, c, h, w]; weight [out, c / groups, kh, kw] (cast to x's
    dtype); bias [out] added in the output's dtype."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"conv2d: data_format {data_format!r}: only NCHW is ported "
            f"(ROADMAP queue 1, item 10(b))")
    out = torch.nn.functional.conv2d(
        x, weight.to(x.dtype), None, _pair(stride, "stride"),
        _pair(padding, "padding"), _pair(dilation, "dilation"), groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out
