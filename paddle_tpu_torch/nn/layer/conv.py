"""``Conv2D``. Counterpart: ``paddle_tpu/nn/layer/conv.py``
(``_ConvNd`` :20-58, ``Conv2D`` :75-85).

The weight is [out, in / groups, kh, kw] float32, KaimingUniform with
the leaky-ReLU gain at slope 0 (bound sqrt(6 / fan_in)); the bias is
Uniform(+-1 / sqrt(fan_in)) (none with ``bias_attr=False``); both drawn
from ``generator`` on ``device`` (``None``: cuda, raising without a
card). ``F.conv2d`` casts the weight to the input's dtype and takes
every padding form and ``data_format`` ("NCHW" or "NHWC") JAX's does;
the weight's layout is the same in both."""
from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["Conv2D"]


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", generator=None, device=None):
        super().__init__()
        if bias_attr not in (None, False):
            raise NotImplementedError(
                "Conv2D: only bias_attr=None or False is ported")
        ks = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = ks
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        dev = resolve_device(device)
        shape = (out_channels, in_channels // groups) + ks
        fan_in = in_channels // groups * ks[0] * ks[1]
        self.weight = nn.Parameter(I.KaimingUniform(
            nonlinearity="leaky_relu")(shape, torch.float32, generator,
                                       dev))
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = None if bias_attr is False else nn.Parameter(
            I.Uniform(-bound, bound)((out_channels,), torch.float32,
                                     generator, dev))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")
