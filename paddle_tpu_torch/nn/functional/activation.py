"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs

__all__ = ["silu", "gelu", "tanh", "softmax"]


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
