"""Tensor ops with the reference's op names (a subset of
``paddle_tpu/tensor/math.py``): each casts its inputs by
``amp.auto_cast``'s policy under its Paddle name before it computes."""
from __future__ import annotations

import torch

from .amp.auto_cast import cast_inputs

__all__ = ["matmul", "add"]


def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y`` with optional transposes of the last two dims (white)."""
    x, y = cast_inputs("matmul", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def add(x, y):
    """``x + y`` (gray)."""
    x, y = cast_inputs("add", x, y)
    return x + y

