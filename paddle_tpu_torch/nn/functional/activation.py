"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``).

The reference computes each one through ``apply`` under its op name,
which XLA fuses into one elementwise kernel: no Pallas kernel. Here each
is torch's op or a few elementwise torch ops, with the reference's
formula where torch's differs (``hardsigmoid``'s default slope 0.1666667,
``prelu``'s ``data_format``, ``selu``'s free ``scale`` and ``alpha``).
The functions added with the ``nn.functional`` surface cast their input
by ``amp.auto_cast`` under the reference's op name; the in-place
variants write the result into ``x``'s storage and return ``x``, as
the tensor ops' in-place variants do. ``rrelu`` (in training) and
``gumbel_softmax`` draw from ``framework.random``'s generator of the
input's device, so their numbers are torch's, not JAX's.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs
from ...framework import random
from ...ops.dispatch import apply
from ...tensor.manipulation import _inplace

__all__ = ["silu", "gelu", "tanh", "softmax", "relu", "relu6", "sigmoid",
           "leaky_relu", "apply", "relu_", "log_sigmoid", "tanh_", "swish",
           "mish", "prelu", "rrelu", "elu", "elu_", "selu", "celu",
           "hardtanh", "hardtanh_", "hardshrink", "softshrink",
           "tanhshrink", "hardsigmoid", "hardswish", "softplus", "softsign",
           "softmax_", "log_softmax", "gumbel_softmax", "maxout", "glu",
           "thresholded_relu", "thresholded_relu_", "leaky_relu_"]

_F = torch.nn.functional


def _op(name, x):
    (x,) = cast_inputs(name, x)
    return x


def silu(x, name=None):
    """``x * sigmoid(x)`` in x's dtype (``jax.nn.silu``)."""
    return _F.silu(x)


def swish(x, name=None):
    """:func:`silu` (the reference's alias)."""
    return silu(x)


def gelu(x, approximate=False, name=None):
    """GELU in x's dtype: exact (erf) by default, the tanh form with
    ``approximate=True`` (``jax.nn.gelu``)."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    """``tanh`` in x's dtype."""
    return torch.tanh(x)


def tanh_(x, name=None):
    return _inplace(x, tanh(x))


def _cast_to(x, dtype):
    if dtype is None:
        return x
    from ...framework.dtype import to_torch_dtype

    return x.to(to_torch_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis`` (a black op under ``auto_cast``: fp32);
    ``dtype`` casts x first, as the reference does."""
    return torch.softmax(_cast_to(_op("softmax", x), dtype), dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    return _inplace(x, softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax over ``axis`` (black under ``auto_cast``)."""
    return torch.log_softmax(_cast_to(_op("log_softmax", x), dtype),
                             dim=axis)


def relu(x, name=None):
    """``max(x, 0)`` (the op ``relu``; gray under ``auto_cast``)."""
    return torch.relu(_op("relu", x))


def relu_(x, name=None):
    return _inplace(x, relu(x))


def relu6(x, name=None):
    """``min(max(x, 0), 6)`` (the op ``relu6``)."""
    return _F.relu6(_op("relu6", x))


def sigmoid(x, name=None):
    """``1 / (1 + exp(-x))`` (the op ``sigmoid``)."""
    return torch.sigmoid(_op("sigmoid", x))


def log_sigmoid(x, name=None):
    """``-softplus(-x)`` (``jax.nn.log_sigmoid``)."""
    return _F.logsigmoid(_op("log_sigmoid", x))


def mish(x, name=None):
    """``x * tanh(softplus(x))``."""
    return _F.mish(_op("mish", x))


def leaky_relu(x, negative_slope=0.01, name=None):
    """``x`` where positive, ``negative_slope * x`` elsewhere (the op
    ``leaky_relu``)."""
    return _F.leaky_relu(_op("leaky_relu", x), negative_slope)


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _inplace(x, leaky_relu(x, negative_slope))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where ``x >= 0``, ``weight * x`` elsewhere: one weight for
    all, or one per channel (dim 1 for ``NCHW``, the last dim else;
    ``activation.py:65``)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """``x`` where ``x >= 0``, else ``slope * x``: the slope drawn
    uniform in ``[lower, upper)`` per element (fp32, cast to x's dtype)
    while ``training``, ``(lower + upper) / 2`` otherwise."""
    x = _op("rrelu", x)
    if not training:
        return torch.where(x >= 0, x, (lower + upper) / 2 * x)
    random.note_draw()
    slope = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    slope.uniform_(lower, upper, generator=random.generator(x.device))
    return torch.where(x >= 0, x, slope.to(x.dtype) * x)


def elu(x, alpha=1.0, name=None):
    return _F.elu(_op("elu", x), alpha)


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, elu(x, alpha))


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    """``scale * (x if x > 0 else alpha * expm1(x))``."""
    x = _op("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return _F.celu(_op("celu", x), alpha)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    """``clip(x, min, max)``."""
    return torch.clamp(_op("hardtanh", x), min, max)


def hardtanh_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _inplace(x, hardtanh(x, min, max))


def hardshrink(x, threshold=0.5, name=None):
    """``x`` where ``|x| > threshold``, else 0."""
    x = _op("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    """``x - threshold`` above it, ``x + threshold`` below its negative,
    else 0."""
    x = _op("softshrink", x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    x = _op("tanhshrink", x)
    return x - torch.tanh(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """``clip(slope * x + offset, 0, 1)``, the reference's slope (not
    torch's 1/6)."""
    return torch.clamp(slope * _op("hardsigmoid", x) + offset, 0.0, 1.0)


def hardswish(x, name=None):
    """``x * clip(x + 3, 0, 6) / 6``."""
    x = _op("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``softplus(beta * x) /
    beta`` (black under ``auto_cast``)."""
    return _F.softplus(_op("softplus", x), beta, threshold)


def softsign(x, name=None):
    x = _op("softsign", x)
    return x / (1 + x.abs())


def thresholded_relu(x, threshold=1.0, name=None):
    """``x`` where ``x > threshold``, else 0."""
    x = _op("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def thresholded_relu_(x, threshold=1.0, name=None):
    return _inplace(x, thresholded_relu(x, threshold))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g`` drawn
    per element (``-log(-log(u))``, ``u`` uniform in ``(0, 1)``); with
    ``hard`` the one-hot of each argmax in the forward and the soft
    gradient in the backward (straight through)."""
    x = _op("gumbel_softmax", x)
    random.note_draw()
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    u.uniform_(generator=random.generator(x.device))
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    idx = y.argmax(dim=axis, keepdim=True)
    onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
    return (onehot - y).detach() + y


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` consecutive channels of
    ``axis``."""
    x = _op("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def glu(x, axis=-1, name=None):
    """``a * sigmoid(b)`` for the two halves ``a, b`` of ``axis``."""
    return _F.glu(_op("glu", x), dim=axis)
