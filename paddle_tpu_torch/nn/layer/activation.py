"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``).

As in the reference, most are made by one factory: a layer takes its
function's keyword defaults positionally or by name (others, such as
``name``, are accepted and ignored) and calls the function with them.
"""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
           "GELU", "SiLU", "Silu", "Swish", "Mish", "LeakyReLU", "ELU",
           "SELU", "CELU", "Hardtanh", "Hardshrink", "Softshrink",
           "Hardsigmoid", "Hardswish", "Softplus", "Softsign", "Softmax",
           "LogSoftmax", "Maxout", "GLU", "RReLU", "PReLU",
           "ThresholdedReLU", "Softmax2D"]


def _act_layer(name, fn, **defaults):
    """A layer class calling ``fn(x, **settings)``: ``defaults``
    overridden by the constructor's arguments, positional ones in the
    defaults' order."""

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            merged = dict(defaults)
            for k, v in zip(defaults, args):
                merged[k] = v
            merged.update((k, v) for k, v in kwargs.items() if k in merged)
            self._kwargs = merged

        def forward(self, x):
            return fn(x, **self._kwargs)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
GELU = _act_layer("GELU", F.gelu, approximate=False)
SiLU = _act_layer("SiLU", F.silu)
Swish = _act_layer("Swish", F.swish)
Mish = _act_layer("Mish", F.mish)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = _act_layer("ELU", F.elu, alpha=1.0)
SELU = _act_layer("SELU", F.selu)
CELU = _act_layer("CELU", F.celu, alpha=1.0)
Hardtanh = _act_layer("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Hardshrink = _act_layer("Hardshrink", F.hardshrink, threshold=0.5)
Softshrink = _act_layer("Softshrink", F.softshrink, threshold=0.5)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardswish = _act_layer("Hardswish", F.hardswish)
Softplus = _act_layer("Softplus", F.softplus, beta=1.0, threshold=20.0)
Softsign = _act_layer("Softsign", F.softsign)
Softmax = _act_layer("Softmax", F.softmax, axis=-1)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax, axis=-1)
Maxout = _act_layer("Maxout", F.maxout, groups=2, axis=1)
GLU = _act_layer("GLU", F.glu, axis=-1)
ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu,
                             threshold=1.0)
Silu = SiLU  # the reference exports both spellings


class RReLU(Layer):
    """Randomized leaky ReLU: a slope drawn from ``U(lower, upper)`` in
    training, their mean in eval."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class PReLU(Layer):
    """Leaky ReLU with a learned slope per channel (``num_parameters``)
    or one for all, starting at ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init), device=device,
            generator=generator)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softmax2D(Layer):
    """Softmax over the channels of a CHW or NCHW input."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3D/4D input, got ndim={x.ndim}")
        return F.softmax(x, axis=-3)
