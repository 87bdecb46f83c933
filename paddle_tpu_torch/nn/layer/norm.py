"""Batch-norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D"]


class _BatchNormBase(Layer):
    """A scale (ones) and a shift (zeros) unless their attr is False, and
    the fp32 running buffers ``_mean`` (zeros) and ``_variance`` (ones),
    named as the reference names them (``norm.py:36-37``), so the two
    packages' ``state_dict`` keys are the same. ``amp.decorate`` at O2
    casts the scale and shift and leaves the buffers fp32."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=dev,
            generator=generator)
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=dev,
            generator=generator)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, "
                f"data_format={self._data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass
