"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Each initializer fills a tensor in place: ``init(tensor, generator)``.
Called on a shape, as the reference's are (``init(shape, dtype)``), it
returns a new tensor on the current device in ``dtype``, or else in the
default dtype (``framework.dtype.get_default_dtype``), narrowed as the
reference's 32-bit mode narrows it (float64 lands as float32).
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

from ..framework import random
from ..framework.device import current_device
from ..framework.dtype import get_default_dtype, to_torch_dtype
from ..tensor._common import _NARROW

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierUniform", "XavierNormal", "KaimingUniform",
           "KaimingNormal", "Assign", "Orthogonal", "Dirac", "Bilinear",
           "calculate_gain", "set_global_initializer", "constant", "normal",
           "uniform"]


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
    returns it; ``init(shape, dtype=None)`` returns a new tensor."""

    def __call__(self, tensor, generator=None):
        if not isinstance(tensor, torch.Tensor):
            d = get_default_dtype() if generator is None \
                else to_torch_dtype(generator)
            tensor = torch.empty(tuple(int(n) for n in tensor),
                                 dtype=_NARROW.get(d, d),
                                 device=current_device())
            generator = random.generator(tensor.device)
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


class TruncatedNormal(Initializer):
    """A normal draw truncated to ``[a, b]`` standard deviations, then
    scaled by ``std`` and shifted by ``mean`` (``initializer.py:79``)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _values(self, tensor, generator):
        t = torch.nn.init.trunc_normal_(self._draw(tensor), 0.0, 1.0,
                                        self.a, self.b, generator=generator)
        return t * self.std + self.mean


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


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix over the first dim and the rest,
    times ``gain``: the Q of a normal draw's QR, its columns' signs made
    those of R's diagonal (``initializer.py:170``)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _values(self, tensor, generator):
        rows = tensor.shape[0]
        cols = math.prod(tensor.shape[1:])
        flat = torch.empty((max(rows, cols), min(rows, cols)),
                           dtype=torch.float32, device=tensor.device)
        flat.normal_(generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(tensor.shape)


class Dirac(Initializer):
    """The identity of a convolution ``[out, in, *k]``: 1 at the kernel's
    centre for channel pair (``g * out / groups + i``, ``i``)
    (``initializer.py:187``)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _values(self, tensor, generator):
        out_c, in_c = tensor.shape[0], tensor.shape[1]
        w = np.zeros(tuple(tensor.shape), np.float32)
        center = tuple(k // 2 for k in tensor.shape[2:])
        per_group = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, in_c)):
                w[(g * per_group + i, i) + center] = 1.0
        return torch.from_numpy(w)


class Bilinear(Initializer):
    """The bilinear upsampling stencil of a square ``[out, in, K, K]``
    transposed-convolution weight, on every channel pair
    (``initializer.py:220``)."""

    def _values(self, tensor, generator):
        shape = tuple(tensor.shape)
        if len(shape) != 4:
            raise ValueError(
                f"Bilinear initializer expects a 4-D conv weight, got "
                f"shape {list(shape)}")
        if shape[2] != shape[3]:
            raise ValueError(
                "Bilinear initializer requires a square kernel "
                f"(got {shape[2]}x{shape[3]})")
        k = shape[2]
        f = (k + 1) // 2
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:k, :k]
        filt = (1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))
        return torch.from_numpy(
            np.broadcast_to(filt, shape).astype(np.float32))


# the reference's lower-case aliases
constant = Constant
normal = Normal
uniform = Uniform

# the global weight and bias initializers (set_global_initializer)
_GLOBAL = [None, None]


def set_global_initializer(weight_init, bias_init=None):
    """Initializers for the parameters that ``create_parameter`` makes
    without an explicit or default initializer: ``weight_init`` for
    weights, ``bias_init`` for biases (None: each keeps its own);
    ``set_global_initializer(None)`` clears both (``initializer.py:210``,
    read at ``layers.py:93-94``)."""
    _GLOBAL[0] = weight_init
    _GLOBAL[1] = bias_init
