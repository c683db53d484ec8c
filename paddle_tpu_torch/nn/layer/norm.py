"""``RMSNorm``, ``LayerNorm`` and the BatchNorm layers. Counterparts:
``paddle_tpu/nn/layer/norm.py`` (``_BatchNormBase`` and its subclasses
:20-84, ``LayerNorm`` :86-112, ``RMSNorm`` :114-128).

RMSNorm's gain takes the layer's dtype (the model's, e.g. bfloat16) and
starts at ones; LayerNorm's gain (ones) and bias (zeros) are float32, as
JAX's ``create_parameter`` makes them for a layer built without a dtype.

A BatchNorm layer's ``weight`` (ones) and ``bias`` (zeros) are float32
parameters (none with ``weight_attr=False`` / ``bias_attr=False``); its
running stats are float32 buffers named ``_mean`` (zeros) and
``_variance`` (ones), as JAX's are, whatever the parameters' dtype.
``F.batch_norm`` updates them in place in training. ``BatchNorm``,
``BatchNorm1D`` and ``BatchNorm2D`` are one layer (the channel is axis 1
of an ``NC*`` layout, else the last), ``BatchNorm3D`` defaults to
``NCDHW``, and ``SyncBatchNorm`` is BatchNorm with
``convert_sync_batchnorm`` the identity, as in JAX."""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["RMSNorm", "LayerNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, dtype="float32",
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(I.Constant(1.0)(
            (hidden_size,), dtype, None, resolve_device(device)))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        dev = resolve_device(device)
        self.weight = None if weight_attr is False else nn.Parameter(
            I.Constant(1.0)(self.normalized_shape, torch.float32, None, dev))
        self.bias = None if bias_attr is False else nn.Parameter(
            I.Constant(0.0)(self.normalized_shape, torch.float32, None, dev))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None, False):
            raise NotImplementedError(
                "BatchNorm: only weight_attr / bias_attr None or False are "
                "ported")
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        dev = resolve_device(device)
        shape = (num_features,)
        self.weight = None if weight_attr is False else nn.Parameter(
            I.Constant(1.0)(shape, torch.float32, None, dev))
        self.bias = None if bias_attr is False else nn.Parameter(
            I.Constant(0.0)(shape, torch.float32, None, dev))
        self.register_buffer("_mean", torch.zeros(shape, device=dev))
        self.register_buffer("_variance", torch.ones(shape, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, device)


class SyncBatchNorm(_BatchNormBase):
    """One card's BatchNorm; ``convert_sync_batchnorm`` returns the layer
    as it is (JAX's batch statistics sync falls out of GSPMD)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer
