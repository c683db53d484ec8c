"""``conv2d``. Counterpart: ``paddle_tpu/nn/functional/conv.py``
(``_norm_padding`` :22-39, ``_conv`` :42-76, ``conv2d`` :79-82).

The weight is in paddle's layout [out, in / groups, kh, kw] and is cast
to x's dtype before the product; the bias is cast to the output's dtype
and added after it, as ``_conv`` does. JAX runs the convolution on XLA,
not in Pallas, so the port's route is ``torch.nn.functional.conv2d``
(cuDNN on the card). ``data_format`` is "NCHW" or "NHWC" (x and the
output; the weight keeps its layout); stride and dilation an int or one
int a spatial dim. ``padding`` takes JAX's forms: "SAME" / "VALID" in
any case, an int, one int a spatial dim, ``[h0, h1, w0, w1]``, or pairs
``[[h0, h1], [w0, w1]]``. "SAME" pads as lax does: ``total = max(0,
(ceil(n / s) - 1) s + (k - 1) d + 1 - n)``, ``total // 2`` low and the
rest high, so at stride 2 on an even size the extra row goes high.
Uneven pads are applied with ``F.pad`` before a conv at padding 0.
Paddle's full form ``[[0, 0], [0, 0], [h0, h1], [w0, w1]]`` raises
``ValueError``, as JAX's does: its four entries take the ``[h0, h1, w0,
w1]`` branch first (``_norm_padding`` :31-32) and make pairs of lists,
which ``conv_general_dilated`` refuses."""
from __future__ import annotations

import torch

__all__ = ["conv2d"]


def _pair(v, what):
    v = (v, v) if isinstance(v, int) else tuple(v)
    if len(v) != 2 or not all(isinstance(e, int) for e in v):
        raise ValueError(f"conv2d: {what} {v!r}: expected an int or one "
                         f"int a spatial dim")
    return v


def _pads(padding, hw, k, stride, dilation):
    """((h0, h1), (w0, w1)) of paddle's ``padding`` for a conv of x's
    spatial size ``hw``, JAX's ``_norm_padding`` resolved."""
    if isinstance(padding, str):
        kind = padding.upper()
        if kind == "VALID":
            return ((0, 0), (0, 0))
        if kind != "SAME":
            raise ValueError(f"conv2d: padding {padding!r}: expected "
                             f"'SAME' or 'VALID'")
        pads = []
        for n, kk, s, d in zip(hw, k, stride, dilation):
            total = max(0, (-(-n // s) - 1) * s + (kk - 1) * d + 1 - n)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return ((padding, padding),) * 2
    p = list(padding)
    if len(p) == 2 and all(isinstance(e, int) for e in p):
        pads = [(e, e) for e in p]
    elif len(p) == 4:
        pads = [(p[0], p[1]), (p[2], p[3])]
    elif all(isinstance(e, (list, tuple)) for e in p):
        pads = [tuple(e) for e in p]
    else:
        raise ValueError(f"conv2d: bad padding {padding!r}")
    if len(pads) != 2 or not all(
            len(e) == 2 and all(isinstance(v, int) for v in e)
            for e in pads):
        raise ValueError(
            f"conv2d: padding {padding!r}: expected an int, one int a "
            f"spatial dim, [h0, h1, w0, w1] or [[h0, h1], [w0, w1]] (the "
            f"full four-pair form is refused, as JAX refuses it)")
    return tuple(pads)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """x [n, c, h, w] (NCHW) or [n, h, w, c] (NHWC); weight [out, c /
    groups, kh, kw] (cast to x's dtype); bias [out] added in the output's
    dtype."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: data_format {data_format!r}: expected "
                         f"'NCHW' or 'NHWC'")
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    stride, dilation = _pair(stride, "stride"), _pair(dilation, "dilation")
    (h0, h1), (w0, w1) = _pads(padding, x.shape[2:], weight.shape[2:],
                               stride, dilation)
    if h0 == h1 >= 0 and w0 == w1 >= 0:
        pad = (h0, w0)
    else:
        x = torch.nn.functional.pad(x, (w0, w1, h0, h1))
        pad = (0, 0)
    out = torch.nn.functional.conv2d(x, weight.to(x.dtype), None, stride,
                                     pad, dilation, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
