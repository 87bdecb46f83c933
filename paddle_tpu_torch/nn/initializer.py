"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Each initializer fills a tensor in place: ``init(tensor, generator)``.
Random ones draw in fp32 from ``generator`` (a ``torch.Generator`` on the
tensor's device) and cast to the tensor's dtype, as the reference draws
in fp32 from a JAX key and casts. The draws are not the reference's bits:
a port model that must compute the reference's function takes its
weights through ``load_jax_weights``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierUniform",
           "XavierNormal", "KaimingUniform", "KaimingNormal", "Assign",
           "calculate_gain"]


def calculate_gain(nonlinearity, param=None):
    """The reference's gain table (``initializer.py:16-30``)."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0,
        "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0,
        "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return gains[nonlinearity]


def _fan_in_out(shape):
    """Conv weights are ``[out, in, *kernel]``; a linear weight is
    ``[in, out]`` (Paddle's layout)."""
    shape = tuple(shape)
    if len(shape) < 2:
        fan = shape[0] if shape else 1
        return fan, fan
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(tensor, generator=None)`` fills ``tensor`` in place and
    returns it."""

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            tensor.copy_(self._values(tensor, generator))
        return tensor

    def _values(self, tensor, generator):
        raise NotImplementedError

    @staticmethod
    def _draw(tensor):
        return torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _values(self, tensor, generator):
        return torch.full(tensor.shape, self.value, dtype=tensor.dtype,
                          device=tensor.device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _values(self, tensor, generator):
        return self._draw(tensor).normal_(self.mean, self.std,
                                          generator=generator)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _values(self, tensor, generator):
        return self._draw(tensor).uniform_(self.low, self.high,
                                           generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _values(self, tensor, generator):
        fi, fo = _fan_in_out(tensor.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)._values(tensor, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _values(self, tensor, generator):
        fi, fo = _fan_in_out(tensor.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)._values(tensor, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _values(self, tensor, generator):
        fi = self.fan_in if self.fan_in is not None \
            else _fan_in_out(tensor.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)._values(tensor, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _values(self, tensor, generator):
        fi = self.fan_in if self.fan_in is not None \
            else _fan_in_out(tensor.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))._values(tensor, generator)


class Assign(Initializer):
    """The given values (an array, a list or a tensor), reshaped to the
    tensor's shape."""

    def __init__(self, value):
        self.value = value

    def _values(self, tensor, generator):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        return v.reshape(tensor.shape)
