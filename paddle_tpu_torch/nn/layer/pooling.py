"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "LPPool2D", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D"]


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


class AdaptiveMaxPool1D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size=output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool3D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size=output_size,
                         return_mask=return_mask)


class LPPool2D(_Pool):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.lp_pool2d, norm_type=norm_type,
                         kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         data_format=data_format)


class _MaxUnPool(Layer):
    """Calls its functional unpool with ``(x, indices)`` and the
    arguments it was made with."""

    def __init__(self, fn, kernel_size, stride, padding, data_format,
                 output_size):
        super().__init__()
        self._fn = fn
        self._kw = dict(kernel_size=kernel_size, stride=stride,
                        padding=padding, output_size=output_size,
                        data_format=data_format)

    def forward(self, x, indices):
        return self._fn(x, indices, **self._kw)


class MaxUnPool1D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(F.max_unpool1d, kernel_size, stride, padding,
                         data_format, output_size)


class MaxUnPool2D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(F.max_unpool2d, kernel_size, stride, padding,
                         data_format, output_size)


class MaxUnPool3D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(F.max_unpool3d, kernel_size, stride, padding,
                         data_format, output_size)
