"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``)."""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    """The weight is ``[out, in / groups, *k]`` in every layout (``[in,
    out / groups, *k]`` for a transposed convolution), drawn
    ``KaimingUniform(fan_in, negative_slope=sqrt(5), nonlinearity=
    "leaky_relu")`` (``U(+-1/sqrt(fan_in))``, ``fan_in = in / groups *
    prod(k)``), and the bias ``U(+-1/sqrt(fan_in))``; ``bias_attr=False``:
    no bias (``conv.py:36-47``). Only ``padding_mode="zeros"`` is
    ported."""

    def __init__(self, fn, in_channels, out_channels, kernel_size, nd,
                 stride, padding, dilation, groups, padding_mode,
                 weight_attr, bias_attr, data_format, device, generator,
                 transpose=False, output_padding=0):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r} is not ported; only "
                f"'zeros'")
        self._fn = fn
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = ((kernel_size,) * nd
                             if isinstance(kernel_size, int)
                             else tuple(kernel_size))
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, *self._kernel_size]
            if transpose else
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=math.sqrt(5.0),
                nonlinearity="leaky_relu"),
            device=device, generator=generator)
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound), device=device,
            generator=generator)

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}, data_format={self._data_format}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(F.conv1d, in_channels, out_channels, kernel_size,
                         1, stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device,
                         generator)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(F.conv2d, in_channels, out_channels, kernel_size,
                         2, stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device,
                         generator)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(F.conv3d, in_channels, out_channels, kernel_size,
                         3, stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device,
                         generator)


class _ConvNdTranspose(_ConvNd):
    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._output_padding, self._groups,
                        self._dilation, output_size, self._data_format)


class Conv1DTranspose(_ConvNdTranspose):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(F.conv1d_transpose, in_channels, out_channels,
                         kernel_size, 1, stride, padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format,
                         device, generator, True, output_padding)


class Conv2DTranspose(_ConvNdTranspose):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(F.conv2d_transpose, in_channels, out_channels,
                         kernel_size, 2, stride, padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format,
                         device, generator, True, output_padding)


class Conv3DTranspose(_ConvNdTranspose):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(F.conv3d_transpose, in_channels, out_channels,
                         kernel_size, 3, stride, padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format,
                         device, generator, True, output_padding)
