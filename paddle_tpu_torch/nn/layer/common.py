"""Common layers: ``Linear``, ``Embedding``, dropout, flattening,
upsampling, padding, pixel shuffles, ``Bilinear``, distances and
``Unfold``/``Fold`` (counterpart of ``paddle_tpu/nn/layer/common.py``).
Each wraps its ``nn.functional`` form; a layer with parameters takes
``device`` and ``generator`` keyword-only (``layers.py``)."""
from __future__ import annotations

import torch

from ...tensor import manipulation as M
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Unflatten", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "PixelShuffle", "PixelUnshuffle",
           "ChannelShuffle", "Bilinear", "CosineSimilarity",
           "PairwiseDistance", "Unfold", "Fold"]


class Linear(Layer):
    """``y = x @ weight + bias`` with Paddle's ``[in, out]`` weight
    (``XavierNormal``) and a zero bias (``bias_attr=False``: none),
    through ``F.linear`` (white under ``amp.auto_cast``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        if in_features <= 0 or out_features <= 0:
            raise ValueError(
                f"paddle.nn.Linear: in_features and out_features must be "
                f"positive, got {in_features} and {out_features}")
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal(), **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table drawn from ``N(0, 1)``;
    row ``padding_idx`` (negative counts from the end) starts at zero and
    ``F.embedding`` gives it no gradient."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0), device=device,
            generator=generator)
        if padding_idx is not None:
            pad = padding_idx if padding_idx >= 0 \
                else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight[pad] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx, self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """``F.dropout`` with the layer's ``p``, ``axis`` and ``mode``, in
    training or eval by the layer's mode."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    """``F.dropout2d``: whole channels of an NCHW (or NHWC) input."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    """``F.dropout3d``: whole channels of an NCDHW (or NDHWC) input."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    """``F.alpha_dropout`` (keeps SELU's mean and variance)."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    """Flattens dims ``start_axis`` to ``stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    """Splits dim ``axis`` into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        return M.unflatten(x, self.axis, self.shape)


class Upsample(Layer):
    """``F.interpolate`` with the layer's arguments."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear upsampling with ``align_corners=True``."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    """Nearest upsampling."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


def _npairs(padding, n):
    """An int pads both edges of each of the ``n`` spatial dims; a list
    passes through (the reference's Pad layers)."""
    return [padding] * (2 * n) if isinstance(padding, int) else padding


class _PadNd(Layer):
    """``F.pad`` with the layer's padding, mode, value and layout."""

    def __init__(self, padding, mode, value, data_format, nd):
        super().__init__()
        self.padding = _npairs(padding, nd)
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value,
                         "NCW" if data_format in ("NCL", "NCW") else "NWC",
                         1)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format, 2)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, 3)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    """``y_o = x1 @ weight[o] @ x2 + bias_o`` with a ``[out, in1, in2]``
    weight (``XavierNormal(fan_in=in1, fan_out=out)``) and a zero
    bias."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=I.XavierNormal(fan_in=in1_features,
                                               fan_out=out_features), **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Unfold(Layer):
    """``F.unfold``: sliding blocks as columns."""

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    """``F.fold``: columns summed back into an image."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)
