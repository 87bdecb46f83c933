"""Per-position symmetric int8 KV quantization.

Counterpart of ``quantize_kv``/``dequantize_kv`` in
``paddle_tpu/quantization/__init__.py``: the one helper pair the int8
KV path uses everywhere — the engine's quantize-on-write
(``serving/engine.py``), the reference round-trip of
``generate(kv_int8=True)``, and the inputs of the int8 paged kernel —
so the three cannot diverge. Bit-identical to the reference on the same
fp32 input: ``torch.round`` rounds half to even like ``jnp.round``, the
clip is +-127, and the scale is one fp32 division.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_kv", "dequantize_kv"]


def quantize_kv(x: torch.Tensor):
    """x ``[..., d]`` -> (q int8 ``[..., d]``, s fp32 ``[...]``): one
    amax scale per (position, kv_head)."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    # a device-side divisor: on CUDA, division by a Python scalar is
    # taken as a multiply by its reciprocal, which rounds differently
    s = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: fp32 multiply, then one cast to
    ``dtype``."""
    return (q.to(torch.float32) * s[..., None]).to(dtype)
