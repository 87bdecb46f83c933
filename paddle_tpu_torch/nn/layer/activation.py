"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "LeakyReLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)

    def extra_repr(self):
        return f"negative_slope={self._negative_slope}"
