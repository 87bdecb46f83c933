"""Normalization (counterpart of ``paddle_tpu/nn/functional/norm.py``)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs

__all__ = ["rms_norm", "layer_norm"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last dim: the mean square in fp32, ``rsqrt``, a
    cast back to x's dtype, then ``* weight``. The training forward and
    the decode path (``models/generation.py``, ``serving/engine.py``)
    share this one copy. A black op under ``auto_cast``: x and weight in
    fp32."""
    x, weight = cast_inputs("rms_norm", x, weight)
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims, computed in
    x's dtype as the reference computes it (``norm.py:112-121``): the
    mean and the (biased) variance are reduced in fp32 and rounded to x's
    dtype (``jnp.mean`` and ``jnp.var`` upcast bf16 for the sum), then
    ``(x - mean) / sqrt(var + epsilon) * weight + bias`` in x's dtype.
    Under O2 bf16 that is bf16 arithmetic, not the fp32 inside
    ``torch.nn.functional.layer_norm``. A black op under ``auto_cast``."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    x32 = x.to(torch.float32)
    mean = x32.mean(dims, keepdim=True)
    var = x32.var(dims, unbiased=False, keepdim=True)
    out = (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
