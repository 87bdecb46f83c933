"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool2D"]


class _Pool(Layer):
    """Calls its functional pool with the arguments it was made with."""

    def __init__(self, fn, **kwargs):
        super().__init__()
        self._fn = fn
        self._kwargs = kwargs

    def forward(self, x):
        return self._fn(x, **self._kwargs)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size=kernel_size,
                         stride=stride, padding=padding,
                         return_mask=return_mask, ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(F.max_pool2d, kernel_size=kernel_size,
                         stride=stride, padding=padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(F.max_pool3d, kernel_size=kernel_size,
                         stride=stride, padding=padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size=kernel_size,
                         stride=stride, padding=padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size=kernel_size,
                         stride=stride, padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(F.avg_pool3d, kernel_size=kernel_size,
                         stride=stride, padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)


class AdaptiveAvgPool1D(_Pool):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size=output_size)


class AdaptiveAvgPool2D(_Pool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size=output_size,
                         data_format=data_format)


class AdaptiveAvgPool3D(_Pool):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(F.adaptive_avg_pool3d, output_size=output_size,
                         data_format=data_format)


class AdaptiveMaxPool2D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size=output_size,
                         return_mask=return_mask)
