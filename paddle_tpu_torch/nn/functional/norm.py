"""Normalization (counterpart of ``paddle_tpu/nn/functional/norm.py``)."""
from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last dim: the mean square in fp32, ``rsqrt``, a
    cast back to x's dtype, then ``* weight``. The training forward and
    the decode path (``models/generation.py``, ``serving/engine.py``)
    share this one copy."""
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
