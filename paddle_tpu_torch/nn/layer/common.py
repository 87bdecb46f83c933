"""``Linear``, ``Flatten`` and ``Dropout`` (counterpart of
``paddle_tpu/nn/layer/common.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .layers import Layer

__all__ = ["Linear", "Flatten", "Dropout"]


class Linear(nn.Module):
    """``y = x @ weight + bias`` with Paddle's ``[in, out]`` weight
    (Xavier-uniform) and a zero bias (``bias_attr=False``: none), through
    ``F.linear`` (white under ``amp.auto_cast``)."""

    def __init__(self, in_features, out_features, bias_attr=None, *,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        bound = (6.0 / (in_features + out_features)) ** 0.5
        w = torch.empty((in_features, out_features), device=dev)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_features, device=dev)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Flatten(Layer):
    """Flattens dims ``start_axis`` to ``stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


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
