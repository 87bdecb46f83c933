"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch

__all__ = ["silu", "gelu", "tanh"]


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
