"""Linear and dropout (counterpart of
``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs
from ...framework import random

__all__ = ["linear", "dropout"]


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with ``weight`` in Paddle's ``[in, out]``
    layout (the reference's op ``linear``: white under ``auto_cast``, so
    x, weight and bias are cast to the low dtype there)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    """Zero each element with probability ``p`` and scale the kept ones
    by ``1 / (1 - p)`` while ``training`` (``upscale_in_train``, the
    reference's default). The Bernoulli mask comes from the device's
    dropout generator (``framework.random.generator``); the reference
    draws it from ``jax.random``, so the two masks differ for one seed
    (the tests compare their statistics). Other modes and ``axis`` are
    not ported."""
    if mode != "upscale_in_train":
        raise NotImplementedError(f"dropout mode {mode!r} is not ported; "
                                  f"only 'upscale_in_train'")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout p must be in [0, 1], got {p!r}")
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    random.note_draw()
    keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1.0 - p, generator=random.generator(x.device))
    return torch.where(keep.bool(), x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))
