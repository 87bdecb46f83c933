"""Layers (counterpart of ``paddle_tpu/nn/layer/common.py``'s
``Linear``)."""
from __future__ import annotations

import torch
from torch import nn

from ..framework.device import resolve_device
from . import functional as F

__all__ = ["Linear"]


class Linear(nn.Module):
    """``y = x @ weight + bias`` with Paddle's ``[in, out]`` weight
    (Xavier-uniform) and a zero bias (``bias_attr=False``: none), through
    ``F.linear`` (white under ``amp.auto_cast``)."""

    def __init__(self, in_features, out_features, bias_attr=None, *,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        bound = (6.0 / (in_features + out_features)) ** 0.5
        w = torch.empty((in_features, out_features), device=dev)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_features, device=dev)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
