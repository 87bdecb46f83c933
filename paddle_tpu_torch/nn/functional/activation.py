"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs

__all__ = ["silu", "gelu", "tanh", "softmax", "relu", "relu6", "sigmoid",
           "leaky_relu"]


def silu(x):
    """``x * sigmoid(x)`` in x's dtype (``jax.nn.silu``)."""
    return torch.nn.functional.silu(x)


def gelu(x, approximate=False):
    """GELU in x's dtype: exact (erf) by default, the tanh form with
    ``approximate=True`` (``jax.nn.gelu``)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x):
    """``tanh`` in x's dtype."""
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None):
    """Softmax over ``axis`` (a black op under ``auto_cast``: fp32);
    ``dtype`` casts x first, as the reference does."""
    (x,) = cast_inputs("softmax", x)
    if dtype is not None:
        from ...framework.dtype import to_torch_dtype

        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def relu(x, name=None):
    """``max(x, 0)`` (the op ``relu``; gray under ``auto_cast``)."""
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    """``min(max(x, 0), 6)`` (the op ``relu6``)."""
    (x,) = cast_inputs("relu6", x)
    return torch.nn.functional.relu6(x)


def sigmoid(x, name=None):
    """``1 / (1 + exp(-x))`` (the op ``sigmoid``)."""
    (x,) = cast_inputs("sigmoid", x)
    return torch.sigmoid(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    """``x`` where positive, ``negative_slope * x`` elsewhere (the op
    ``leaky_relu``)."""
    (x,) = cast_inputs("leaky_relu", x)
    return torch.nn.functional.leaky_relu(x, negative_slope)
